/* WebRTC media plane: signalling (/ws) + RTCPeerConnection playback.
 *
 * Counterpart of the reference client's signalling.js + webrtc.js
 * (addons/gst-web/src): registers as peer 1 (HELLO), answers the
 * server's offer, trickles ICE both ways, renders the incoming video
 * track into a <video> element, and carries the input/control protocol
 * on an RTCDataChannel named "input".  Exposes the same facade as
 * SelkiesMedia (connect/send/onMessage/onStats) so the app shell can
 * fall back to the WS plane when negotiation fails.
 */
"use strict";

class SelkiesWebRTC {
  constructor(videoEl, onMessage, onStats, session) {
    this.videoEl = videoEl;
    this.onMessage = onMessage;
    this.onStats = onStats || (() => {});
    // fleet peer-id convention (parallel/fleet.py): session k's browser
    // registers as 1+10k; session 0 is the reference's plain peer 1
    this.session = session | 0;
    this.peerId = 1 + 10 * this.session;
    this.ws = null;
    this.pc = null;
    this.dc = null;
    this.connected = false;
    this.closed = false;
    this.bytesReceived = 0;
    this.framesDecoded = 0;
    this.framesDropped = 0;
    this._statsTimer = null;
    this._jbTimer = null;
    this._probe = null;
    this._pendingCandidates = [];
    // cluster redirect state (mirrors signalling/client.py): the ws URL
    // a REDIRECT record re-targeted us to, and the recent hop chain
    this._wsUrl = null;
    this._redirectPath = [];
    // distinguishes a _fail-initiated close (resurrectable by a racing
    // REDIRECT — the server tears down WebRTC around the same instant
    // it redirects) from an app-initiated close() (final)
    this._failed = false;
  }

  async connect() {
    let iceServers = [];
    try {
      const cfg = await (await fetch("./turn")).json();
      iceServers = cfg.iceServers || [];
    } catch (e) { /* STUN-less LAN still works via host candidates */ }
    const proto = location.protocol === "https:" ? "wss:" : "ws:";
    this.ws = new WebSocket(this._wsUrl || `${proto}//${location.host}/ws`);
    this.ws.onopen = () => {
      const meta = {
        res: `${Math.round(innerWidth * devicePixelRatio)}x${Math.round(innerHeight * devicePixelRatio)}`,
        scale: devicePixelRatio,
        // codec preference list for per-client negotiation
        // (signalling/negotiate.py). Default keeps h264 first (no
        // behaviour change); `?codec=av1` or `?codec=vp9,h264` opts a
        // client into another row the server resolves against its
        // registry + chip carve.
        codecs: this._codecPreferences(),
      };
      this.ws.send(`HELLO ${this.peerId} ${btoa(JSON.stringify(meta))}`);
    };
    this.ws.onclose = () => {
      if (!this.closed && !this.connected) this._fail("signalling closed");
    };
    this.ws.onmessage = (ev) => this._signal(ev.data, iceServers);
  }

  _codecPreferences() {
    const forced = new URLSearchParams(location.search).get("codec");
    if (forced) return forced.split(",").map((c) => c.trim().toLowerCase()).filter(Boolean);
    let caps = null;
    try {
      if (window.RTCRtpReceiver && RTCRtpReceiver.getCapabilities)
        caps = RTCRtpReceiver.getCapabilities("video");
    } catch (e) { /* capability probe is best-effort */ }
    if (!caps || !caps.codecs) return ["h264"];
    const have = new Set(caps.codecs.map((c) => (c.mimeType || "").toLowerCase()));
    const order = [["video/h264", "h264"], ["video/av1", "av1"],
                   ["video/vp9", "vp9"], ["video/vp8", "vp8"]];
    const out = order.filter(([m]) => have.has(m)).map(([, n]) => n);
    return out.length ? out : ["h264"];
  }

  _signal(data, iceServers) {
    if (data === "HELLO" || data.startsWith("SESSION_OK")) return;
    if (data.startsWith("REDIRECT ")) { this._onRedirect(data); return; }
    if (data.startsWith("ERROR")) { console.warn("signalling:", data); return; }
    let obj;
    try { obj = JSON.parse(data); } catch (e) { return; }
    if (obj.sdp && obj.sdp.type === "offer") this._onOffer(obj.sdp, iceServers);
    else if (obj.ice) this._onRemoteIce(obj.ice);
  }

  /* cluster/router.py ws_url_of: advertised base URL -> signalling WS URL */
  _wsUrlOf(host) {
    host = String(host).replace(/\/+$/, "");
    if (host.startsWith("ws://") || host.startsWith("wss://")) {
      return host.split("://", 2)[1].includes("/") ? host : host + "/ws";
    }
    if (host.startsWith("https://")) return "wss://" + host.slice(8) + "/ws";
    if (host.startsWith("http://")) return "ws://" + host.slice(7) + "/ws";
    return "ws://" + host + "/ws";
  }

  /* Server-initiated redirect record (cluster plane: drain migrate-off,
   * capacity/codec routing) — the browser counterpart of
   * signalling/client.py._on_redirect. Re-targets the signalling URL,
   * re-registers under the landing slot's peer id when the record names
   * one, and reconnects after the retry-after beat. Chains are capped
   * the same way (4 hops / 60 s, never back to a host already in the
   * chain) so two misconfigured hosts can never ping-pong a browser. */
  _onRedirect(data) {
    let rd;
    try { rd = JSON.parse(atob(data.slice("REDIRECT ".length).trim())); }
    catch (e) { console.warn("ignoring malformed redirect record"); return; }
    if (!rd || !rd.host) return;
    // a drain's WebRTC teardown can race ahead of this record and trip
    // _fail -> close(); the server-directed move still stands — only an
    // app-initiated close() is final
    if (this.closed && !this._failed) return;
    this.closed = false;
    this._failed = false;
    const target = this._wsUrlOf(rd.host);
    const proto = location.protocol === "https:" ? "wss:" : "ws:";
    const origin = this._wsUrl || `${proto}//${location.host}/ws`;
    const now = performance.now();
    this._redirectPath = this._redirectPath.filter(([, t]) => now - t < 60000);
    const seen = new Set(this._redirectPath.map(([h]) => h));
    const hops = Math.max(0, this._redirectPath.length - 1);
    if (seen.has(target) || hops >= 4) {
      console.warn(`ignoring redirect to ${target}: chain capped (${hops} recent hops)`);
      return;
    }
    if (!this._redirectPath.length) this._redirectPath.push([origin, now]);
    this._redirectPath.push([target, now]);
    if (rd.session !== null && rd.session !== undefined) {
      // migrated sessions can land on a different slot index on the
      // target; re-register under its peer id (fleet 1+10k convention)
      this.session = rd.session | 0;
      this.peerId = 1 + 10 * this.session;
    }
    this._wsUrl = target;
    const delayMs = Math.max(0, (rd.retry_after_s || 0.5) * 1000);
    console.warn(`server redirected us to ${target} (${rd.reason || "?"}, retry in ${delayMs}ms)`);
    // tear down without tripping _fail: the move is server-directed
    this.connected = false;
    if (this._statsTimer) clearInterval(this._statsTimer);
    if (this._jbTimer) clearInterval(this._jbTimer);
    this.stopLatencyProbe();
    if (this.dc) { this.dc.onclose = null; this.dc.onmessage = null; try { this.dc.close(); } catch (e) {} this.dc = null; }
    if (this.pc) { this.pc.onconnectionstatechange = null; this.pc.ontrack = null; try { this.pc.close(); } catch (e) {} this.pc = null; }
    if (this.ws) { this.ws.onclose = null; this.ws.onmessage = null; try { this.ws.close(); } catch (e) {} this.ws = null; }
    this.onStats({ event: "redirect", reason: rd.reason || "", host: String(rd.host) });
    setTimeout(() => { if (!this.closed) this.connect(); }, delayMs);
  }

  async _onOffer(desc, iceServers) {
    if (this.pc) {
      // detach the old peer's handlers first: its dc.onclose firing
      // during close() must not tear down the replacement
      if (this.dc) { this.dc.onclose = null; this.dc.onmessage = null; }
      this.pc.onconnectionstatechange = null;
      this.pc.ontrack = null;
      this.pc.close();
      this.connected = false;
    }
    const pc = new RTCPeerConnection({ iceServers });
    this.pc = pc;
    pc.ontrack = (ev) => {
      if (ev.track.kind === "video" || !this.videoEl.srcObject) {
        this.videoEl.srcObject = ev.streams[0] || new MediaStream([ev.track]);
        this.videoEl.play().catch(() => {});
      }
    };
    pc.onicecandidate = (ev) => {
      if (ev.candidate && this.ws.readyState === WebSocket.OPEN) {
        this.ws.send(JSON.stringify({ ice: {
          candidate: ev.candidate.candidate,
          sdpMLineIndex: ev.candidate.sdpMLineIndex || 0,
        }}));
      }
    };
    pc.onconnectionstatechange = () => {
      if (pc.connectionState === "failed" || pc.connectionState === "closed") {
        this._fail(`peer connection ${pc.connectionState}`);
      }
    };
    const dc = pc.createDataChannel("input", { ordered: true });
    this.dc = dc;
    dc.onopen = () => {
      this.connected = true;
      this.onStats({ event: "open" });
      this._startStats();
      this._startJitterBufferLoop();
    };
    dc.onmessage = (ev) => {
      try {
        const obj = JSON.parse(ev.data);
        if (obj.type === "codec") return;  // track decode is codec-agnostic
        this.onMessage(obj);
      } catch (e) { console.warn(e); }
    };
    dc.onclose = () => { if (this.connected) this._fail("datachannel closed"); };
    await pc.setRemoteDescription(desc);
    for (const c of this._pendingCandidates) await this._addIce(c);
    this._pendingCandidates = [];
    const answer = await pc.createAnswer();
    await pc.setLocalDescription(answer);
    this.ws.send(JSON.stringify({ sdp: { type: "answer", sdp: answer.sdp } }));
  }

  async _onRemoteIce(ice) {
    if (!this.pc || !this.pc.remoteDescription) {
      this._pendingCandidates.push(ice);
      return;
    }
    await this._addIce(ice);
  }

  async _addIce(ice) {
    try {
      await this.pc.addIceCandidate({
        candidate: ice.candidate, sdpMLineIndex: ice.sdpMLineIndex || 0, sdpMid: "video0",
      });
    } catch (e) { console.debug("addIceCandidate:", e); }
  }

  /* RTC stats loop (reference webrtc.js getConnectionStats :494-684 +
   * app.js upload loop :456-537): a full extraction every second feeds
   * the drawer's live panel via this.connectionStats; the video report
   * list is uploaded as _stats_video (the server's loss-based congestion
   * controller reads the first inbound-rtp entry) and the audio reports
   * as _stats_audio every 5th tick. */
  _startStats() {
    let tick = 0;
    this._statsTimer = setInterval(async () => {
      if (!this.pc) return;
      try {
        const stats = await this.pc.getStats();
        const videoReports = [], audioReports = [];
        const codecs = {}, candidates = {};
        let nominatedPair = null, succeededPair = null;
        const cs = this.connectionStats = this.connectionStats || {};
        stats.forEach((r) => {
          if (r.type === "codec") codecs[r.id] = r.mimeType;
          if (r.type === "inbound-rtp" && r.kind === "video") {
            videoReports.push(r);
            this.framesDecoded = r.framesDecoded || 0;
            this.framesDropped = r.framesDropped || 0;
            this.bytesReceived = r.bytesReceived || 0;
            this.keyFramesDecoded = r.keyFramesDecoded || 0;
            cs.packetsReceived = r.packetsReceived;
            cs.packetsLost = r.packetsLost;
            cs.jitterMs = (r.jitter || 0) * 1000;
            if (r.jitterBufferDelay && r.jitterBufferEmittedCount) {
              cs.jitterBufferMs = r.jitterBufferDelay / r.jitterBufferEmittedCount * 1000;
            }
            if (r.frameWidth) cs.resolution = `${r.frameWidth}x${r.frameHeight}`;
            cs.videoCodecId = r.codecId;
            cs.decoder = r.decoderImplementation;
          }
          if (r.type === "inbound-rtp" && r.kind === "audio") {
            audioReports.push(r);
            cs.audioCodecId = r.codecId;
            cs.audioPacketsLost = r.packetsLost;
          }
          if (r.type === "candidate-pair") {
            // several pairs can be 'succeeded' (ICE restarts, kept-alive
            // relay paths); the route in use is the nominated pair that
            // is still succeeding — a stale nominated pair lingers in
            // getStats as 'failed' after a network change
            if (r.nominated && r.state === "succeeded") nominatedPair = r;
            else if (r.state === "succeeded" && !succeededPair) succeededPair = r;
          }
          if (r.type === "remote-candidate" || r.type === "local-candidate") {
            candidates[r.id] = r.candidateType;
          }
        });
        cs.videoCodec = codecs[cs.videoCodecId];
        cs.audioCodec = codecs[cs.audioCodecId];
        const selectedPair = nominatedPair || succeededPair;
        if (selectedPair) {
          videoReports.push(selectedPair);
          if (selectedPair.currentRoundTripTime !== undefined) {
            cs.rttMs = selectedPair.currentRoundTripTime * 1000;
          }
          if (selectedPair.availableIncomingBitrate) {
            cs.availableKbps = Math.round(selectedPair.availableIncomingBitrate / 1000);
          }
          // classify the route from the SELECTED pair's candidates —
          // gathered-but-unused relay candidates must not label a
          // direct connection as TURN
          const local = candidates[selectedPair.localCandidateId];
          const remote = candidates[selectedPair.remoteCandidateId];
          cs.candidateType = (local === "relay" || remote === "relay")
            ? "relay (TURN)" : (local || remote);
        }
        if (tick % 5 === 0) {
          this.send(`_stats_video,${JSON.stringify(videoReports)}`);
          if (audioReports.length) {
            this.send(`_stats_audio,${JSON.stringify(audioReports)}`);
          }
        }
        tick += 1;
      } catch (e) { /* stats are best-effort */ }
    }, 1000);
  }

  /* jitterBufferTarget=0 enforcement loop (reference app.js:542-551):
   * the browser resets its receive jitter buffer target whenever the
   * network wobbles, so a one-shot assignment drifts back up; poking
   * every receiver every 15 ms pins playout at minimum latency. The
   * legacy playoutDelayHint is set too for pre-M106 engines. */
  _startJitterBufferLoop() {
    if (this._jbTimer) clearInterval(this._jbTimer);
    this._jbTimer = setInterval(() => {
      if (!this.pc) return;
      for (const receiver of this.pc.getReceivers()) {
        try {
          // guard: the setter posts cross-thread work in Chromium, so
          // only re-pin when something actually moved it off zero
          if ("jitterBufferTarget" in receiver && receiver.jitterBufferTarget !== 0) {
            receiver.jitterBufferTarget = 0;
          }
          if ("playoutDelayHint" in receiver && receiver.playoutDelayHint !== 0) {
            receiver.playoutDelayHint = 0;
          }
        } catch (e) { /* per-spec the setter may throw mid-renegotiation */ }
      }
    }, 15);
  }

  /* Glass-to-glass latency probe (reference webrtc.js fun()/capture(),
   * :763-824): samples the bottom-left 1% of each rendered video frame
   * and reports per-frame brightness + inter-frame interval. Trigger a
   * visible change in that corner (e.g. a terminal cursor) and read the
   * timestamps to measure capture->encode->network->decode->render.
   * Returns a stop() function; results stream to onSample. */
  startLatencyProbe(onSample) {
    this.stopLatencyProbe();
    const video = this.videoEl;
    const canvas = document.createElement("canvas");
    const ctx = canvas.getContext("2d", { willReadFrequently: true });
    let last = performance.now();
    const tick = () => {
      if (!this._probe) return;
      const w = Math.max(1, Math.floor(video.videoWidth / 10));
      const h = Math.max(1, Math.floor(video.videoHeight / 10));
      if (w > 1 && h > 1) {
        canvas.width = w; canvas.height = h;
        // bottom-left corner of the frame
        ctx.drawImage(video, 0, video.videoHeight - h, w, h, 0, 0, w, h);
        const d = ctx.getImageData(0, 0, w, h).data;
        let sum = 0;
        for (let i = 0; i < d.length; i += 4) sum += d[i] + d[i + 1] + d[i + 2];
        const now = performance.now();
        onSample({ brightness: sum / (d.length / 4) / 3, intervalMs: now - last, t: now });
        last = now;
      }
      this._probe = video.requestVideoFrameCallback
        ? video.requestVideoFrameCallback(tick)
        : requestAnimationFrame(tick);
    };
    this._probe = video.requestVideoFrameCallback
      ? video.requestVideoFrameCallback(tick)
      : requestAnimationFrame(tick);
    return () => this.stopLatencyProbe();
  }

  stopLatencyProbe() {
    if (this._probe) {
      if (this.videoEl.cancelVideoFrameCallback) {
        this.videoEl.cancelVideoFrameCallback(this._probe);
      } else {
        cancelAnimationFrame(this._probe);
      }
      this._probe = null;
    }
  }

  send(msg) {
    if (this.dc && this.dc.readyState === "open") this.dc.send(msg);
  }

  _fail(reason) {
    if (this.closed) return;
    console.warn("webrtc plane failed:", reason);
    const wasConnected = this.connected;
    this._failed = true;
    this.close();
    this.onStats({ event: wasConnected ? "close" : "failed", reason });
  }

  close() {
    this.closed = true;
    this.connected = false;
    if (this._statsTimer) clearInterval(this._statsTimer);
    if (this._jbTimer) clearInterval(this._jbTimer);
    this.stopLatencyProbe();
    if (this.dc) try { this.dc.close(); } catch (e) {}
    if (this.pc) try { this.pc.close(); } catch (e) {}
    if (this.ws) try { this.ws.close(); } catch (e) {}
  }
}
