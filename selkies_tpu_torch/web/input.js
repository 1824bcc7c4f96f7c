/* Input capture: DOM events → the selkies data-channel CSV protocol.
 *
 * Counterpart of the reference client's input.js (addons/gst-web/src/
 * input.js): kd/ku keysyms, m/m2 mouse with 5-bit button mask + scroll
 * magnitude, kr reset on focus changes, js gamepad messages from a 16 ms
 * poll loop, r/s resize + scaling reports.
 */
"use strict";

const SMOOTH_SCROLL_PX = 53;  // px of smooth scroll per wheel tick

class SelkiesInput {
  constructor(canvas, send) {
    this.canvas = canvas;
    this.send = send;          // (msg: string) => void
    this.buttonMask = 0;
    this.remoteWidth = 1280;
    this.remoteHeight = 720;
    this.pointerLock = false;
    this._gamepadTimer = null;
    this._attached = [];
    this._keys = new KeyTracker();
    // when false, window resizes do NOT push r/s to the server — the
    // user pinned a manual remote resolution / scaling in the UI and
    // automatic reports would silently clobber it
    this.autoResize = true;
  }

  attach() {
    const c = this.canvas;
    const on = (target, type, fn) => {
      target.addEventListener(type, fn);
      this._attached.push([target, type, fn]);
    };
    on(window, "keydown", (ev) => this._key(ev, true));
    on(window, "keyup", (ev) => this._key(ev, false));
    on(window, "blur", () => {
      // release every held key BEFORE the kr reset: the server clears
      // its modifier state, but explicit ku for remembered keysyms
      // keeps applications that track keys themselves consistent
      for (const sym of this._keys.releaseAll()) this.send("ku," + sym);
      this.send("kr");
    });
    on(window, "compositionend", (ev) => this._composition(ev));
    on(window, "focus", () => this._uploadClipboard());
    on(c, "mousemove", (ev) => this._mouse(ev));
    on(c, "mousedown", (ev) => this._button(ev, true));
    on(c, "mouseup", (ev) => this._button(ev, false));
    on(c, "wheel", (ev) => this._wheel(ev));
    on(c, "touchstart", (ev) => this._touchStart(ev));
    on(c, "touchmove", (ev) => this._touchMove(ev));
    on(c, "touchend", (ev) => this._touchEnd(ev));
    on(c, "touchcancel", (ev) => this._touchCancel(ev));
    on(c, "contextmenu", (ev) => ev.preventDefault());
    on(c, "click", () => this._maybePointerLock());
    on(document, "pointerlockchange", () => this._pointerLockChanged());
    on(document, "fullscreenchange", () => this._fullscreenChanged());
    on(window, "gamepadconnected", (ev) => this._gamepadConnected(ev));
    on(window, "gamepaddisconnected", (ev) => this._gamepadDisconnected(ev));
    on(window, "resize", () => this._reportResize());
    this._reportResize();
    this._uploadClipboard();
  }

  /* Server pushed clipboard content: remember it so the focus-upload
   * doesn't echo the same text straight back. */
  noteRemoteClipboard(text) {
    this._lastClipboard = text;
  }

  /* Local clipboard -> server on focus (the reference uploads on focus
   * so the remote session always has the user's latest copy;
   * input.js "cw" path). Gated on the async permission-aware API. */
  _uploadClipboard() {
    if (!navigator.clipboard?.readText) return;
    navigator.clipboard.readText().then((text) => {
      if (!text || text === this._lastClipboard) return;
      this._lastClipboard = text;
      this.send("cw," + btoa(unescape(encodeURIComponent(text))));
    }).catch(() => {});  // permission denied / not focused
  }

  /* IME composition result: type each codepoint as press+release (the
   * raw keydowns during composition were swallowed as "Process"). */
  _composition(ev) {
    for (const ch of ev.data || "") {
      const sym = keysymFromCodepoint(ch.codePointAt(0));
      this.send("kd," + sym);
      this.send("ku," + sym);
    }
  }

  /* -- pointer lock (relative mouse mode, reference input.js flow) --- */

  requestPointerLock() {
    this.pointerLock = true;
    this.canvas.requestPointerLock?.();
  }

  exitPointerLock() {
    this.pointerLock = false;
    if (document.pointerLockElement) document.exitPointerLock();
  }

  _maybePointerLock() {
    if (this.pointerLock && !document.pointerLockElement) {
      this.canvas.requestPointerLock?.();
    }
  }

  _pointerLockChanged() {
    if (!document.pointerLockElement) this.send("kr");  // modifiers reset
  }

  /* -- fullscreen + keyboard lock ------------------------------------ */

  async enterFullscreen() {
    const el = this.canvas.parentElement || this.canvas;
    await el.requestFullscreen?.();
    // capture Escape / Meta / browser shortcuts while fullscreen
    // (reference: input.js keyboard-lock block)
    try { await navigator.keyboard?.lock?.(); } catch (e) { /* unsupported */ }
  }

  _fullscreenChanged() {
    if (!document.fullscreenElement) {
      navigator.keyboard?.unlock?.();
      this.send("kr");
    }
  }

  detach() {
    for (const [target, type, fn] of this._attached) target.removeEventListener(type, fn);
    this._attached = [];
    if (this._gamepadTimer) clearInterval(this._gamepadTimer);
  }

  _key(ev, down) {
    if (ev.isComposing || ev.key === "Process") return;  // IME owns these
    // KeyTracker releases the keysym that was PRESSED for this physical
    // key even if modifiers/layout changed mid-hold (stuck-key bug)
    const keysym = down ? this._keys.down(ev) : this._keys.up(ev);
    if (keysym === null) return;
    ev.preventDefault();
    this.send((down ? "kd," : "ku,") + keysym);
  }

  _coords(ev) {
    const r = this.canvas.getBoundingClientRect();
    const x = Math.round((ev.clientX - r.left) * (this.remoteWidth / r.width));
    const y = Math.round((ev.clientY - r.top) * (this.remoteHeight / r.height));
    return [Math.max(0, Math.min(this.remoteWidth, x)), Math.max(0, Math.min(this.remoteHeight, y))];
  }

  _sendMouse(ev, magnitude = 0) {
    if (this.pointerLock && document.pointerLockElement) {
      this.send(`m2,${ev.movementX},${ev.movementY},${this.buttonMask},${magnitude}`);
    } else {
      const [x, y] = this._coords(ev);
      this.send(`m,${x},${y},${this.buttonMask},${magnitude}`);
    }
  }

  _mouse(ev) { this._sendMouse(ev); }

  _button(ev, down) {
    ev.preventDefault();
    const bit = 1 << ev.button;      // DOM button order matches mask LSB=left
    if (down) this.buttonMask |= bit; else this.buttonMask &= ~bit;
    this._sendMouse(ev);
  }

  _wheel(ev) {
    ev.preventDefault();
    // trackpad-vs-mouse heuristic (reference input.js:270-325): mouse
    // wheels report large discrete deltas (~100-120 px or LINE mode);
    // trackpads stream many small pixel-mode deltas. Discrete wheels
    // emit scaled ticks directly; trackpad streams ACCUMULATE and emit
    // one tick per threshold crossing so smooth scrolling doesn't
    // machine-gun the server with max-rate wheel events.
    let dy = ev.deltaY;
    if (ev.deltaMode === 1) dy *= 40;        // DOM_DELTA_LINE
    else if (ev.deltaMode === 2) dy *= 400;  // DOM_DELTA_PAGE
    if (dy === 0) return;  // horizontal-only (tilt wheel): no vertical tick
    const discrete = ev.deltaMode !== 0 || Math.abs(dy) >= 100;
    let ticks;
    if (discrete) {
      this._wheelAcc = 0;
      ticks = Math.sign(dy) * Math.min(15, Math.max(1, Math.round(Math.abs(dy) / 100)));
    } else {
      this._wheelAcc = (this._wheelAcc || 0) + dy;
      ticks = Math.trunc(this._wheelAcc / SMOOTH_SCROLL_PX);
      if (ticks === 0) return;
      this._wheelAcc -= ticks * SMOOTH_SCROLL_PX;
    }
    const [x, y] = this._coords(ev);
    this._emitWheelTicks(ticks, x, y);
  }

  /* Emit |ticks| wheel scrolls at (x, y): shared by the wheel handler
   * and the two-finger touch scroll so the bit/pair protocol lives in
   * one place. */
  _emitWheelTicks(ticks, x, y) {
    const bit = ticks < 0 ? 8 : 16;  // mask bits 3/4 = wheel up/down
    this.buttonMask |= bit;
    this.send(`m,${x},${y},${this.buttonMask},${Math.min(15, Math.abs(ticks))}`);
    this.buttonMask &= ~bit;
    this.send(`m,${x},${y},${this.buttonMask},0`);
  }

  // -- touch (touchscreen → pointer protocol) ---------------------------

  _touchPoint(t) {
    // Touch objects carry the same clientX/clientY the mouse helper reads
    return this._coords(t);
  }

  _touchStart(ev) {
    ev.preventDefault();
    if (ev.touches.length === 1) {
      // single finger: move there, press left (press happens on a short
      // delay so a two-finger gesture can cancel it into a right-click
      // or scroll — the reference's long-press/tap model simplified)
      const [x, y] = this._touchPoint(ev.touches[0]);
      this._touchXY = [x, y];
      this.send(`m,${x},${y},${this.buttonMask},0`);
      this._touchTimer = setTimeout(() => {
        // read the CURRENT position: a fast touch-drag has moved since
        const [px, py] = this._touchXY;
        this.buttonMask |= 1;
        this.send(`m,${px},${py},${this.buttonMask},0`);
        this._touchTimer = null;
      }, 60);
    } else if (ev.touches.length === 2) {
      // second finger joined: cancel the pending left press; this is a
      // scroll (moves) or right-click (tap) gesture
      if (this._touchTimer) { clearTimeout(this._touchTimer); this._touchTimer = null; }
      if (this.buttonMask & 1) {
        this.buttonMask &= ~1;
        const [x, y] = this._touchXY || [0, 0];
        this.send(`m,${x},${y},${this.buttonMask},0`);
      }
      this._twoFingerY = (ev.touches[0].clientY + ev.touches[1].clientY) / 2;
      this._twoFingerMoved = false;
      if (!this._touchXY) this._touchXY = this._touchPoint(ev.touches[0]);
    }
  }

  _touchMove(ev) {
    ev.preventDefault();
    if (this._touchGhost) return;  // straggler finger after 2-finger lift
    if (ev.touches.length === 1) {
      const [x, y] = this._touchPoint(ev.touches[0]);
      this._touchXY = [x, y];
      this.send(`m,${x},${y},${this.buttonMask},0`);
    } else if (ev.touches.length === 2 && this._twoFingerY !== undefined) {
      // two-finger drag scrolls like a trackpad (accumulate px → ticks)
      const y = (ev.touches[0].clientY + ev.touches[1].clientY) / 2;
      const dy = this._twoFingerY - y;
      this._twoFingerY = y;
      if (Math.abs(dy) > 2) this._twoFingerMoved = true;
      // separate accumulator from the wheel path: residue from one
      // modality must not bias the other's first tick
      this._touchScrollAcc = (this._touchScrollAcc || 0) + dy * (window.devicePixelRatio || 1);
      const ticks = Math.trunc(this._touchScrollAcc / SMOOTH_SCROLL_PX);
      if (ticks !== 0) {
        this._touchScrollAcc -= ticks * SMOOTH_SCROLL_PX;
        const [px, py] = this._touchXY || this._touchPoint(ev.touches[0]);
        this._emitWheelTicks(ticks, px, py);
      }
    }
  }

  _touchEnd(ev) {
    ev.preventDefault();
    if (this._touchTimer) {
      // finger lifted before the press timer: emit a full click
      clearTimeout(this._touchTimer);
      this._touchTimer = null;
      const [x, y] = this._touchXY || [0, 0];
      this.buttonMask |= 1;
      this.send(`m,${x},${y},${this.buttonMask},0`);
      this.buttonMask &= ~1;
      this.send(`m,${x},${y},${this.buttonMask},0`);
      return;
    }
    if (this._twoFingerY !== undefined && ev.touches.length < 2) {
      // staggered lift: tear the gesture down (and fire the tap) as
      // soon as the FIRST finger leaves — browsers deliver one touchend
      // per finger, so waiting for length 0 would drop the gesture.
      // Swallow the remaining finger's events afterwards so a trailing
      // single touch doesn't teleport the cursor mid-scroll.
      if (!this._twoFingerMoved) {
        // two-finger tap: right click at the gesture position
        const [x, y] = this._touchXY || [0, 0];
        this.buttonMask |= 4;
        this.send(`m,${x},${y},${this.buttonMask},0`);
        this.buttonMask &= ~4;
        this.send(`m,${x},${y},${this.buttonMask},0`);
      }
      this._twoFingerY = undefined;
      this._touchScrollAcc = 0;
      this._touchGhost = ev.touches.length > 0;  // ignore the straggler
    }
    if (ev.touches.length === 0) {
      this._touchGhost = false;
      if (this.buttonMask & 1) {
        const [x, y] = this._touchXY || [0, 0];
        this.buttonMask &= ~1;
        this.send(`m,${x},${y},${this.buttonMask},0`);
      }
    }
  }

  _touchCancel(ev) {
    // the platform aborted the touch (edge swipe, palm rejection,
    // notification shade): release state WITHOUT synthesizing a click
    ev.preventDefault();
    if (this._touchTimer) {
      clearTimeout(this._touchTimer);
      this._touchTimer = null;
    }
    this._twoFingerY = undefined;
    this._touchGhost = false;
    if (this.buttonMask & 1) {
      const [x, y] = this._touchXY || [0, 0];
      this.buttonMask &= ~1;
      this.send(`m,${x},${y},${this.buttonMask},0`);
    }
  }

  /* Force-push the local clipboard to the server (UI button path);
   * shares the cw encoding and the _lastClipboard dedup with the
   * focus-upload so the next focus doesn't re-send the same text. */
  pushClipboard() {
    if (!navigator.clipboard?.readText) return;
    navigator.clipboard.readText().then((text) => {
      if (!text) return;
      this._lastClipboard = text;
      this.send("cw," + btoa(unescape(encodeURIComponent(text))));
    }).catch(() => {});
  }

  _reportResize() {
    if (!this.autoResize) return;
    const w = Math.round(window.innerWidth * window.devicePixelRatio);
    const h = Math.round(window.innerHeight * window.devicePixelRatio);
    this.send(`r,${w}x${h}`);
    this.send(`s,${window.devicePixelRatio}`);
  }

  // -- gamepads (16 ms poll like the reference's gamepad.js) ------------

  _gamepadConnected(ev) {
    const gp = ev.gamepad;
    const name64 = btoa(unescape(encodeURIComponent(gp.id)));
    this.send(`js,c,${gp.index},${name64},${gp.axes.length},${gp.buttons.length}`);
    if (!this._gamepadTimer) {
      this._state = {};
      this._gamepadTimer = setInterval(() => this._pollGamepads(), 16);
    }
  }

  _gamepadDisconnected(ev) {
    this.send(`js,d,${ev.gamepad.index}`);
  }

  _pollGamepads() {
    for (const gp of navigator.getGamepads()) {
      if (!gp) continue;
      const st = this._state[gp.index] || (this._state[gp.index] = { b: [], a: [] });
      gp.buttons.forEach((btn, i) => {
        if (st.b[i] !== btn.value) {
          st.b[i] = btn.value;
          this.send(`js,b,${gp.index},${i},${btn.value}`);
        }
      });
      gp.axes.forEach((v, i) => {
        if (st.a[i] !== v) {
          st.a[i] = v;
          this.send(`js,a,${gp.index},${i},${v.toFixed(4)}`);
        }
      });
    }
  }
}
