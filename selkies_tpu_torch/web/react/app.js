// @ts-check
/**
 * Typed client variant — the gst-web-react counterpart (App.tsx).
 *
 * Same wire protocol as ../app.js through the shared planes
 * (SelkiesMedia / SelkiesWebRTC / SelkiesInput, classic scripts), with
 * the React client's distinguishing features rebuilt on the local
 * component runtime (ui.js): URL-parameter connection config
 * (config.js), an in-page DEBUG OVERLAY with live log capture toggled
 * without reload (App.tsx:1052-1064 parity), a stats panel, and a
 * settings drawer driving the same _arg_/vb/s control vocabulary.
 */
"use strict";

import { h, mount, useState } from "./ui.js";
import { baseUrls, getConnectionConfig } from "./config.js";

const cfg = getConnectionConfig();
const urls = baseUrls(cfg);

/** localStorage persistence per app name (reference app.js:190-212). */
const store = {
  /** @param {string} k @param {string | null} d */
  get: (k, d) => localStorage.getItem(`${cfg.appName}:${k}`) ?? d,
  /** @param {string} k @param {string} v */
  set: (k, v) => localStorage.setItem(`${cfg.appName}:${k}`, v),
};

// ---------------------------------------------------------------------------
// Shared state outside the component tree (media elements must survive
// re-renders) + a tiny pub/sub the components subscribe to via props.
// ---------------------------------------------------------------------------

const state = {
  status: "connecting…",
  plane: "ws",
  debug: cfg.debug,
  serverLatencyMs: 0,
  fps: 0,
  encoder: "",
  system: /** @type {Record<string, unknown> | null} */ (null),
  /** @type {string[]} */
  logs: [],
  /** live plane counters (reference getConnectionStats() subset) */
  stats: { framesDecoded: 0, framesDropped: 0, keyFrames: 0,
           mbitRate: 0, gamepads: 0 },
  statsOpen: false,
  renderUi: () => {},
};

/** @param {string} line */
function logDebug(line) {
  state.logs.push(`${new Date().toISOString().slice(11, 19)} ${line}`);
  if (state.logs.length > 200) state.logs.shift();
  if (state.debug) state.renderUi();
}

const canvas = /** @type {HTMLCanvasElement} */ (
  document.getElementById("screen"));
const videoEl = /** @type {HTMLVideoElement} */ (
  document.getElementById("screen-video"));

/** @type {SelkiesMedia} */
const media = new SelkiesMedia(canvas, onServerMessage, onPlaneEvent);
/** @type {SelkiesWebRTC | null} */
let rtc = null;
/** @type {{send: (m: string) => void}} */
let plane = media;
const input = new SelkiesInput(canvas, (m) => plane.send(m));

let framesThisSecond = 0;
let lastDecoded = 0;

/** @param {SelkiesServerMessage} msg */
function onServerMessage(msg) {
  logDebug(`<- ${JSON.stringify(msg).slice(0, 120)}`);
  if (msg.type === "ping") {
    plane.send(`pong,${Date.now() / 1000}`);
  } else if (msg.type === "system_stats" || msg.type === "system") {
    state.system = /** @type {Record<string, unknown>} */ (msg);
    const action = msg.data && /** @type {{action?: string}} */ (msg.data).action;
    if (typeof action === "string" && action.startsWith("encoder,")) {
      state.encoder = action.slice("encoder,".length);
    }
    state.renderUi();
  } else if (msg.type === "latency_measurement") {
    // payload shape is {type, data: {latency_ms}} (pipeline/app.py
    // send_latency_time) — reading msg.latency_ms pinned this at 0
    const d = /** @type {{latency_ms?: number}} */ (msg.data || {});
    state.serverLatencyMs = Number(d.latency_ms || 0);
    state.renderUi();
  } else if (msg.type === "clipboard") {
    // payload shape is {type, data: {content: b64}} (send_clipboard_data)
    const d = /** @type {{content?: string}} */ (msg.data || {});
    const text = typeof d.content === "string" ? atob(d.content) : "";
    if (text) navigator.clipboard?.writeText(text).catch(() => {});
  }
}

/** @param {SelkiesStatsEvent} ev */
function onPlaneEvent(ev) {
  if (ev.event) logDebug(`plane ${state.plane}: ${ev.event} ${ev.reason || ""}`);
  if (ev.event === "open") {
    state.status = `streaming (${state.plane})`;
    sendInitialPrefs();
    state.renderUi();
  } else if (ev.event === "failed" && state.plane === "rtc") {
    // WebRTC plane failed: release the start guard, fall back to the
    // WS plane (same policy as the default client shell)
    started = false;
    state.plane = "ws";
    plane = media;
    videoEl.style.display = "none";
    canvas.style.display = "";
    // input must follow the visible surface: a display:none element
    // receives no mouse/touch events
    input.detach();
    input.canvas = canvas;
    input.attach();
    media.connect(`${urls.ws}/media`);
    state.renderUi();
  } else if (ev.event === "close") {
    started = false; // terminal for this attempt: allow the retry
    state.status = "disconnected — retrying";
    setTimeout(start, 2000);
    state.renderUi();
  }
}

function sendInitialPrefs() {
  const fps = store.get("framerate", null);
  if (fps) plane.send(`_arg_fps,${fps}`);
  const resize = store.get("resize", null);
  if (resize !== null) {
    const res = `${Math.round(innerWidth * devicePixelRatio)}x${Math.round(innerHeight * devicePixelRatio)}`;
    plane.send(`_arg_resize,${resize},${res}`);
  }
}

let started = false;
function start() {
  // reentrancy guard: every plane "close" schedules a retry, and
  // repeated failure cycles must not stack live SelkiesWebRTC
  // instances (leaked peer connections + timers). The guard holds
  // until the attempt terminally fails or closes (onPlaneEvent
  // clears it); the previous instance is closed before replacement.
  if (started) return;
  started = true;
  if (rtc && rtc.close) {
    try { rtc.close(); } catch (e) { logDebug(`rtc close: ${e}`); }
  }
  state.plane = "rtc";
  rtc = new SelkiesWebRTC(videoEl, onServerMessage, onPlaneEvent);
  plane = /** @type {{send: (m: string) => void}} */ (rtc);
  input.detach();
  input.canvas = videoEl;
  input.attach();
  videoEl.style.display = "";
  canvas.style.display = "none";
  rtc.connect().catch((e) => {
    logDebug(`rtc connect error: ${e}`);
    onPlaneEvent({ event: "failed", reason: String(e) });
  });
}

// client metrics upload every 5 s (_f fps, _l latency — reference
// app.js:604-607)
let lastBytes = 0;
setInterval(() => {
  const src = state.plane === "rtc" && rtc ? rtc : media;
  const decoded = src.framesDecoded;
  framesThisSecond = (decoded - lastDecoded) / 5;
  lastDecoded = decoded;
  state.fps = Math.max(0, Math.round(framesThisSecond));
  const bytes = src.bytesReceived || 0;
  state.stats = {
    framesDecoded: decoded,
    framesDropped: src.framesDropped || 0,
    keyFrames: /** @type {{keyFramesDecoded?: number}} */ (src).keyFramesDecoded || 0,
    mbitRate: Math.max(0, (bytes - lastBytes) * 8 / 5 / 1e6),
    gamepads: (() => {
      try { return [...(navigator.getGamepads?.() || [])].filter(Boolean).length; }
      catch (e) { return 0; }  // SecurityError in permission-less iframes
    })(),
  };
  lastBytes = bytes;
  if (plane && /** @type {{connected?: boolean}} */ (src).connected) {
    plane.send(`_f,${state.fps}`);
    plane.send(`_l,${Math.round(state.serverLatencyMs)}`);
  }
  state.renderUi();
}, 5000);

// ---------------------------------------------------------------------------
// Components
// ---------------------------------------------------------------------------

/** @param {{state: typeof state}} props */
function StatusBar({ state: s }) {
  return h("div", { class: "rx-status" },
    `${s.status}  ·  plane ${s.plane}  ·  ${s.fps} fps  ·  ` +
    `${s.serverLatencyMs.toFixed(0)} ms`);
}

/** @param {{state: typeof state}} props */
function DebugOverlay({ state: s }) {
  if (!s.debug) return h("span", null);
  const sys = s.system ? JSON.stringify(s.system).slice(0, 300) : "-";
  return h("div", { class: "rx-debug" },
    h("div", null, `app=${cfg.appName} server=${urls.http}`),
    h("div", null, `system: ${sys}`),
    h("pre", null, s.logs.slice(-14).join("\n")));
}

/** @param {{state: typeof state}} props */
function StatsPanel({ state: s }) {
  if (!s.statsOpen) return h("span", null);
  const row = (/** @type {string} */ k, /** @type {string | number} */ v) =>
    h("div", null, `${k}: ${v}`);
  return h("div", { class: "rx-stats" },
    row("plane", s.plane),
    row("fps", s.fps),
    row("bitrate", `${s.stats.mbitRate.toFixed(2)} Mbit/s`),
    row("frames decoded", s.stats.framesDecoded),
    row("frames dropped", s.stats.framesDropped),
    row("key frames", s.stats.keyFrames),
    row("latency", `${s.serverLatencyMs.toFixed(0)} ms`),
    row("gamepads", s.stats.gamepads));
}

function SettingsDrawer() {
  const [open, setOpen] = useState(false);
  const resolutions = ["auto", "1280x720", "1920x1080", "2560x1440", "3840x2160"];
  const drawer = h("div", { class: "rx-drawer" + (open ? " open" : "") },
    h("label", null, "Remote resolution ",
      h("select", {
        onChange: (/** @type {Event} */ e) => {
          const v = /** @type {HTMLSelectElement} */ (e.target).value;
          store.set("resolution", v);
          if (v === "auto") {
            // follow the window: remote resizing on, auto reports on
            input.autoResize = true;
            store.set("resize", "true");
            const res = `${Math.round(innerWidth * devicePixelRatio)}x${Math.round(innerHeight * devicePixelRatio)}`;
            plane.send(`_arg_resize,true,${res}`);
          } else {
            // pin a manual resolution: remote resizing stays ENABLED on
            // the server (the resize path is gated on it) but window
            // resizes must stop pushing r/s or they'd clobber the pin
            input.autoResize = false;
            store.set("resize", "true");
            plane.send(`_arg_resize,true,${v}`);
            plane.send(`r,${v}`);
          }
        },
      }, ...resolutions.map((v) =>
        h("option", v === store.get("resolution", "auto") ? { selected: "" } : null, v)))),
    h("label", null, "UI scaling ",
      h("select", {
        onChange: (/** @type {Event} */ e) => {
          const v = /** @type {HTMLSelectElement} */ (e.target).value;
          store.set("scaling", v);
          input.autoResize = false;  // a pinned DPI must survive resizes
          plane.send(`s,${v}`);
        },
      }, ...["0.75", "1", "1.25", "1.5", "2"].map((v) =>
        h("option", v === store.get("scaling", "1") ? { selected: "" } : null, v)))),
    h("label", null, "Frames per second ",
      h("select", {
        onChange: (/** @type {Event} */ e) => {
          const v = /** @type {HTMLSelectElement} */ (e.target).value;
          store.set("framerate", v);
          plane.send(`_arg_fps,${v}`);
        },
      }, ...["15", "30", "60", "120"].map((v) =>
        h("option", v === store.get("framerate", "60") ? { selected: "" } : null, v)))),
    h("label", null, "Bitrate (kbit/s) ",
      h("select", {
        onChange: (/** @type {Event} */ e) =>
          plane.send(`vb,${/** @type {HTMLSelectElement} */ (e.target).value}`),
      }, ...["2000", "4000", "8000", "12000", "20000", "40000"].map(
        (v) => h("option", null, v)))),
    h("label", null, "Audio bitrate (kbit/s) ",
      h("select", {
        onChange: (/** @type {Event} */ e) =>
          plane.send(`ab,${Number(/** @type {HTMLSelectElement} */ (e.target).value) * 1000}`),
      }, ...["32", "64", "96", "128", "256", "320"].map(
        (v) => h("option", null, v)))),
    state.encoder !== "" &&
      h("div", { class: "rx-row" }, `encoder: ${state.encoder}`),
    h("button", {
      onClick: () => {
        state.debug = !state.debug;   // no-reload debug toggle
        logDebug(`debug ${state.debug ? "on" : "off"}`);
        state.renderUi();
      },
    }, "Toggle debug overlay"),
    h("button", {
      onClick: () => {
        state.statsOpen = !state.statsOpen;
        state.renderUi();
      },
    }, "Toggle stats"),
    h("button", {
      onClick: () => input.enterFullscreen(),
    }, "Fullscreen"),
    h("button", {
      onClick: () => {
        if (input.pointerLock) input.exitPointerLock();
        else input.requestPointerLock();
        state.renderUi();
      },
      title: "relative mouse mode (games)",
    }, input.pointerLock ? "Release pointer" : "Pointer lock"),
    h("button", {
      onClick: () => input.pushClipboard(),
    }, "Paste clipboard to remote"));
  return h("div", null,
    h("div", {
      class: "rx-gear", title: "settings",
      onClick: () => setOpen(!open),
    }, "⚙"),
    drawer);
}

/** @param {{state: typeof state}} props */
function App({ state: s }) {
  return h("div", null,
    StatusBar({ state: s }),
    DebugOverlay({ state: s }),
    StatsPanel({ state: s }),
    SettingsDrawer());
}

const uiRoot = /** @type {HTMLElement} */ (document.getElementById("ui"));
state.renderUi = mount(App, { state }, uiRoot);
start();
