/* App shell: wires media + input + the server→client message vocabulary.
 *
 * Counterpart of the reference app.js (addons/gst-web/src/app.js): handles
 * pipeline/system/cursor/clipboard/ping/stats messages, uploads client
 * metrics (_f fps, _l latency) every 5 s, answers ping with pong, fetches
 * ./turn before connecting, persists settings in localStorage.
 */
"use strict";

(function () {
  const canvas = document.getElementById("screen");
  const hud = document.getElementById("hud");
  const statusEl = document.getElementById("status");

  const urlParams = new URLSearchParams(location.search);
  const appName = urlParams.get("app") || "selkies-tpu";
  // fleet mode (--tpu_sessions N): ?session=k targets session k's media
  // plane and signalling peer pair (parallel/fleet.py)
  const session = Math.max(0, parseInt(urlParams.get("session") || "0", 10) || 0);
  const store = {
    get: (k, d) => localStorage.getItem(appName + ":" + k) ?? d,
    set: (k, v) => localStorage.setItem(appName + ":" + k, v),
  };

  const windowRes = () =>
    `${Math.round(innerWidth * devicePixelRatio)}x${Math.round(innerHeight * devicePixelRatio)}`;

  let serverLatency = 0;
  let cursorStyleEl = null;

  const videoEl = document.getElementById("screen-video");
  // two byte planes, same protocol: WebRTC preferred (SRTP/UDP media +
  // RTCDataChannel control), the /media WebSocket as fallback
  const media = new SelkiesMedia(canvas, onChannelMessage, onMediaEvent);
  let rtc = null;
  let plane = media;            // where input/control messages go
  let wsStarted = false;
  const input = new SelkiesInput(canvas, (msg) => plane.send(msg));

  function sendInitialPrefs() {
    // initial client prefs (reference: _arg_fps/_arg_resize on connect)
    const fps = store.get("framerate", null);
    if (fps) plane.send(`_arg_fps,${fps}`);
    const manualRes = store.get("manualResolution", "");
    if (manualRes) {
      // a pinned manual resolution survives reloads: remote resizing
      // stays enabled server-side (the resize path is gated on it) but
      // auto window reports must not clobber the pin
      input.autoResize = false;
      plane.send(`_arg_resize,true,${manualRes}`);
      plane.send(`r,${manualRes}`);
      return;
    }
    const resizePref = store.get("resize", null);
    if (resizePref !== null) {
      const res = windowRes();
      plane.send(`_arg_resize,${resizePref},${res}`);
    }
  }

  function useElement(el, other) {
    el.style.display = "";
    other.style.display = "none";
    input.detach();
    input.canvas = el;
    input.attach();
    el.focus && el.focus();
  }

  function startWs() {
    if (wsStarted) return;
    wsStarted = true;
    const proto = location.protocol === "https:" ? "wss:" : "ws:";
    const path = session > 0 ? `/media/${session}` : "/media";
    media.connect(`${proto}//${location.host}${path}`);
  }

  function startRtc() {
    if (!window.RTCPeerConnection || !window.SelkiesWebRTC) { startWs(); return; }
    rtc = new SelkiesWebRTC(videoEl, onChannelMessage, onRtcEvent, session);
    rtc.connect();
    const attempt = rtc;          // a stale timer must not kill a newer attempt
    setTimeout(() => {
      if (attempt === rtc && !attempt.connected) { attempt.close(); startWs(); }
    }, 8000);
  }

  function onRtcEvent(ev) {
    if (ev.event === "open") {
      plane = rtc;
      statusEl.textContent = "connected (webrtc)";
      useElement(videoEl, canvas);
      // autoplay policy forces muted playback; restore audio on the
      // first user gesture (reference plays after interaction too)
      const unmute = () => { videoEl.muted = false; };
      window.addEventListener("pointerdown", unmute, { once: true });
      window.addEventListener("keydown", unmute, { once: true });
      sendInitialPrefs();
    } else if (ev.event === "failed" || ev.event === "close") {
      plane = media;
      useElement(canvas, videoEl);
      startWs();
      setTimeout(startRtc, 3000);   // the server re-offers on reconnect
    }
  }

  function onMediaEvent(ev) {
    if (plane !== media && ev.event !== "open") return;
    statusEl.textContent = ev.event === "open" ? "connected" : "reconnecting…";
    if (ev.event === "open" && plane === media) {
      input.attach();
      sendInitialPrefs();
    }
  }

  function onChannelMessage(obj) {
    const d = obj.data;
    switch (obj.type) {
      case "ping":
        media.send(`pong,${d.start_time}`);
        break;
      case "latency_measurement":
        serverLatency = d.latency_ms;
        break;
      case "system":
        onSystemAction(d.action);
        break;
      case "cursor":
        onCursor(d);
        break;
      case "clipboard": {
        const text = atob(d.content);
        input.noteRemoteClipboard(text);  // don't echo it back on focus
        navigator.clipboard?.writeText(text).catch(() => {});
        break;
      }
      case "system_stats":
      case "gpu_stats":
        updateHud(obj.type, d);
        break;
      case "pipeline":
        statusEl.textContent = d.status || "";
        break;
      default:
        console.debug("unhandled message", obj);
    }
  }

  function onSystemAction(action) {
    const [verb, value] = action.split(",");
    switch (verb) {
      case "reload": location.reload(); break;
      case "framerate":
        store.set("framerate", value);
        fpsSel.value = value;
        break;
      case "video_bitrate":
        store.set("videoBitRate", value);
        if ([...vbSel.options].some((o) => o.value === value)) vbSel.value = value;
        break;
      case "audio_bitrate": {
        store.set("audioBitRate", value);
        const kb = String(Math.round(Number(value) / 1000));
        if ([...abSel.options].some((o) => o.value === kb)) abSel.value = kb;
        break;
      }
      case "encoder":
        store.set("encoder", value);
        // reference labels hardware vs software rows (app.js:761-766);
        // tpu* rows are the accelerator class here
        document.getElementById("enc-name").textContent =
          (value.startsWith("tpu") ? "tpu (" : "software (") + value + ")";
        break;
      case "resize": {
        const on = value.toLowerCase() === "true";
        store.set("resize", String(on));
        resizeChk.checked = on;
        break;
      }
      case "resolution": {
        const [w, h] = value.split("x").map(Number);
        input.remoteWidth = w; input.remoteHeight = h;
        break;
      }
    }
  }

  function onCursor(d) {
    if (!cursorStyleEl) {
      cursorStyleEl = document.createElement("style");
      document.head.appendChild(cursorStyleEl);
    }
    if (d.override === "none" || !d.curdata) {
      canvas.style.cursor = "none";
      return;
    }
    const hot = d.hotspot || { x: 0, y: 0 };
    canvas.style.cursor =
      `url(data:image/png;base64,${d.curdata}) ${hot.x} ${hot.y}, auto`;
  }

  const hudState = {};
  function updateHud(kind, d) {
    hudState[kind] = d;
    const s = hudState.system_stats, g = hudState.gpu_stats;
    hud.textContent =
      `fps ${fps.toFixed(0)}  latency ${serverLatency.toFixed(1)}ms\n` +
      (s ? `cpu ${s.cpu_percent}%  mem ${(s.mem_used / 1e9).toFixed(1)}/${(s.mem_total / 1e9).toFixed(1)}G\n` : "") +
      (g ? `tpu ${(g.load * 100).toFixed(0)}%  hbm ${(g.memory_used / 1e3).toFixed(1)}/${(g.memory_total / 1e3).toFixed(1)}G` : "");
  }

  // client-side fps measurement + 5 s metric uploads (reference app.js:604)
  let fps = 0, lastFrames = 0, lastBytes = 0, rxKbps = 0, lastSrc = null;
  setInterval(() => {
    const src = (plane === rtc && rtc) ? rtc : media;
    if (src !== lastSrc) {
      // plane failover: each plane has its own counters; differencing
      // across the switch would produce a huge negative sample that the
      // 5 s uploader would forward to the server
      lastSrc = src;
      lastFrames = src.framesDecoded || 0;
      lastBytes = src.bytesReceived || 0;
      return;
    }
    fps = Math.max(0, src.framesDecoded - lastFrames);
    lastFrames = src.framesDecoded;
    rxKbps = Math.max(0, Math.round(((src.bytesReceived || 0) - lastBytes) * 8 / 1000));
    lastBytes = src.bytesReceived || 0;
    updateStatsPanel(src);
  }, 1000);

  // live connection-stats panel in the drawer (reference drawer stats,
  // app.js getConnectionStats surface)
  function updateStatsPanel(src) {
    const panel = document.getElementById("stats-panel");
    if (!drawer.classList.contains("open")) return;
    const cs = (src === rtc && rtc) ? (rtc.connectionStats || {}) : {};
    const lines = [
      `plane        ${src === rtc ? "webrtc" : "websocket"}`,
      `fps          ${fps}`,
      `bitrate      ${rxKbps} kbit/s`,
      `latency      ${serverLatency.toFixed(1)} ms`,
      `frames       ${src.framesDecoded || 0} decoded, ${src.framesDropped || 0} dropped`,
      `received     ${((src.bytesReceived || 0) / 1e6).toFixed(1)} MB`,
    ];
    if (cs.videoCodec) lines.push(`codec        ${cs.videoCodec}${cs.audioCodec ? " + " + cs.audioCodec : ""}`);
    if (cs.resolution) lines.push(`resolution   ${cs.resolution}`);
    if (cs.packetsLost !== undefined) lines.push(`packets      ${cs.packetsReceived || 0} rx, ${cs.packetsLost} lost`);
    if (cs.jitterMs !== undefined) lines.push(`jitter       ${cs.jitterMs.toFixed(1)} ms`);
    if (cs.jitterBufferMs !== undefined) lines.push(`jitter buf   ${cs.jitterBufferMs.toFixed(1)} ms`);
    if (cs.rttMs !== undefined) lines.push(`ice rtt      ${cs.rttMs.toFixed(1)} ms`);
    if (cs.availableKbps) lines.push(`available    ${cs.availableKbps} kbit/s`);
    if (cs.candidateType) lines.push(`route        ${cs.candidateType}`);
    if (cs.decoder) lines.push(`decoder      ${cs.decoder}`);
    panel.textContent = lines.join("\n");
  }
  setInterval(() => {
    if (!media.connected) return;
    media.send(`_f,${Math.round(fps)}`);
    media.send(`_l,${Math.round(serverLatency)}`);
    // full stats report (reference app.js:456-537 uploads getStats();
    // the WS transport reports the decoder-side equivalents)
    media.send("_stats_video," + JSON.stringify({
      type: "inbound-rtp", kind: "video",
      framesDecoded: media.framesDecoded,
      framesDropped: media.framesDropped || 0,
      bytesReceived: media.bytesReceived || 0,
      keyFramesDecoded: media.keyFramesDecoded || 0,
      latencyMs: serverLatency,
    }));
  }, 5000);

  // -- settings drawer (reference app.js:685-769 system-action loop) ---
  const drawer = document.getElementById("drawer");
  document.getElementById("gear").addEventListener("click", () => {
    drawer.classList.toggle("open");
  });
  const fpsSel = document.getElementById("set-fps");
  fpsSel.value = store.get("framerate", "60");
  fpsSel.addEventListener("change", () => {
    store.set("framerate", fpsSel.value);
    plane.send(`_arg_fps,${fpsSel.value}`);
  });
  const resizeChk = document.getElementById("set-resize");
  resizeChk.checked = store.get("resize", "true") === "true";
  resizeChk.addEventListener("change", () => {
    store.set("resize", String(resizeChk.checked));
    const res = windowRes();
    plane.send(`_arg_resize,${resizeChk.checked},${res}`);
  });
  const vbSel = document.getElementById("set-vb");
  vbSel.value = store.get("videoBitRate", "8000");
  vbSel.addEventListener("change", () => {
    store.set("videoBitRate", vbSel.value);
    plane.send(`vb,${vbSel.value}`);
  });
  const abSel = document.getElementById("set-ab");
  abSel.value = String(Math.round(Number(store.get("audioBitRate", "128000")) / 1000));
  abSel.addEventListener("change", () => {
    const bps = Number(abSel.value) * 1000;
    store.set("audioBitRate", String(bps));
    plane.send(`ab,${bps}`);
  });
  const resSel = document.getElementById("set-res");
  resSel.value = store.get("manualResolution", "");
  resSel.addEventListener("change", () => {
    store.set("manualResolution", resSel.value);
    if (resSel.value) {
      // pin a manual remote resolution: remote resizing stays ENABLED
      // on the server (the resize path is gated on it) but auto window
      // reports stop so they don't clobber the pin (react-variant
      // semantics; survives reload via sendInitialPrefs)
      input.autoResize = false;
      plane.send(`_arg_resize,true,${resSel.value}`);
      plane.send(`r,${resSel.value}`);
    } else {
      input.autoResize = true;
      const res = windowRes();
      plane.send(`_arg_resize,${store.get("resize", "true")},${res}`);
    }
  });
  const plChk = document.getElementById("set-pointerlock");
  plChk.addEventListener("change", () => {
    if (plChk.checked) input.requestPointerLock(); else input.exitPointerLock();
  });
  document.getElementById("btn-fullscreen").addEventListener("click", () => {
    input.enterFullscreen();
    drawer.classList.remove("open");
  });
  document.getElementById("btn-hud").addEventListener("click", () => {
    hud.style.display = hud.style.display === "none" ? "" : "none";
  });
  // keyboard shortcut: Ctrl+Shift+F fullscreen (reference default)
  window.addEventListener("keydown", (ev) => {
    if (ev.ctrlKey && ev.shiftKey && ev.code === "KeyF") {
      ev.preventDefault();
      input.enterFullscreen();
    }
  }, true);

  // PWA service worker (reference sw.js)
  if ("serviceWorker" in navigator && location.protocol === "https:") {
    navigator.serviceWorker.register("sw.js").catch(() => {});
  }

  startRtc();
  canvas.focus();
})();
