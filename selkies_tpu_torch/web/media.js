/* Media plane: /media WebSocket → WebCodecs decode → canvas + audio.
 *
 * Replaces the reference client's RTCPeerConnection video path
 * (addons/gst-web/src/webrtc.js) for the WS transport: binary messages are
 * framed as [u8 kind][u8 flags][u16 seq][u32 ts] + payload (see
 * selkies_tpu/transport/websocket.py).  Video is H.264 Annex-B decoded by
 * VideoDecoder; audio is Opus decoded by AudioDecoder into WebAudio.
 * Text messages carry the server→client data-channel JSON vocabulary.
 */
"use strict";

const KIND_VIDEO = 1, KIND_AUDIO = 2, FLAG_KEYFRAME = 1;

const CODEC_STRINGS = {
  h264: "avc1.42E01F",         // constrained baseline (matches the SPS)
  vp9: "vp09.00.41.08",        // profile 0, level 4.1 (covers 1080p60), 8-bit
  vp8: "vp8",
  av1: "av01.0.13M.08",        // profile 0, level 5.1 (1080p60 + 4K30), 8-bit
  h265: "hvc1.1.6.L123.00",    // Main profile, level 4.1 (1080p60)
};

class SelkiesMedia {
  constructor(canvas, onMessage, onStats) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.onMessage = onMessage;   // (obj) => void  — data channel JSON
    this.onStats = onStats || (() => {});
    this.ws = null;
    this.codec = "h264";
    this.videoDecoder = null;
    this.audioCtx = null;
    this.audioDecoder = null;
    this.framesDecoded = 0;
    this.framesDropped = 0;
    this.keyFramesDecoded = 0;
    this.bytesReceived = 0;
    this.lastFrameAt = 0;
    this.connected = false;
  }

  connect(url) {
    this.ws = new WebSocket(url);
    this.ws.binaryType = "arraybuffer";
    this.ws.onopen = () => { this.connected = true; this.onStats({ event: "open" }); };
    this.ws.onclose = () => {
      this.connected = false;
      this.onStats({ event: "close" });
      setTimeout(() => this.connect(url), 3000);   // reference: reconnect in 3 s
    };
    this.ws.onmessage = (ev) => {
      if (typeof ev.data === "string") {
        try {
          const obj = JSON.parse(ev.data);
          if (obj.type === "codec") this._setCodec(obj.data.codec);
          else this.onMessage(obj);
        } catch (e) { console.warn(e); }
      } else {
        this._media(ev.data);
      }
    };
  }

  send(msg) {
    if (this.ws && this.ws.readyState === WebSocket.OPEN) this.ws.send(msg);
  }

  _media(buf) {
    const dv = new DataView(buf);
    const kind = dv.getUint8(0), flags = dv.getUint8(1), seq = dv.getUint16(2), ts = dv.getUint32(4);
    const payload = new Uint8Array(buf, 8);
    this.bytesReceived += buf.byteLength;
    if (kind === KIND_VIDEO) {
      // congestion-control feedback: echo seq + local receive time (the
      // server only uses deltas, so clock offset cancels)
      this.send(`_ack,${seq},${performance.now().toFixed(1)}`);
      this._video(payload, ts, (flags & FLAG_KEYFRAME) !== 0);
    } else if (kind === KIND_AUDIO) this._audio(payload, ts);
  }

  _setCodec(codec) {
    if (!(codec in CODEC_STRINGS)) { console.warn("unknown codec", codec); return; }
    if (codec !== this.codec && this.videoDecoder) {
      try { this.videoDecoder.close(); } catch (e) { /* already closed */ }
      this.videoDecoder = null;
      this.framesDecoded = 0;
    }
    this.codec = codec;
  }

  _ensureVideoDecoder() {
    if (this.videoDecoder && this.videoDecoder.state !== "closed") return true;
    if (typeof VideoDecoder === "undefined") return false;
    this.videoDecoder = new VideoDecoder({
      output: (frame) => this._paint(frame),
      error: (e) => { console.error("video decode", e); this.videoDecoder = null; },
    });
    // Annex-B / raw VP9 frames: no description; keyframes are in-band
    this.videoDecoder.configure({ codec: CODEC_STRINGS[this.codec], optimizeForLatency: true });
    return true;
  }

  _video(payload, ts, key) {
    if (!this._ensureVideoDecoder()) return;
    if (this.videoDecoder.state !== "configured") { this.framesDropped++; return; }
    if (this.framesDecoded === 0 && !key) { this.framesDropped++; return; }  // wait for an IDR
    if (key) this.keyFramesDecoded++;
    this.videoDecoder.decode(new EncodedVideoChunk({
      type: key ? "key" : "delta",
      timestamp: Math.round(ts * 1000 / 90),        // 90 kHz → µs
      data: payload,
    }));
  }

  _paint(frame) {
    if (this.canvas.width !== frame.displayWidth || this.canvas.height !== frame.displayHeight) {
      this.canvas.width = frame.displayWidth;
      this.canvas.height = frame.displayHeight;
    }
    this.ctx.drawImage(frame, 0, 0);
    frame.close();
    this.framesDecoded++;
    this.lastFrameAt = performance.now();
  }

  _ensureAudio() {
    if (this.audioDecoder && this.audioDecoder.state !== "closed") return true;
    if (typeof AudioDecoder === "undefined") return false;
    this.audioCtx = this.audioCtx || new AudioContext({ sampleRate: 48000 });
    this._audioTime = 0;
    this.audioDecoder = new AudioDecoder({
      output: (data) => this._play(data),
      error: (e) => { console.error("audio decode", e); this.audioDecoder = null; },
    });
    this.audioDecoder.configure({ codec: "opus", sampleRate: 48000, numberOfChannels: 2 });
    return true;
  }

  _audio(payload, ts) {
    if (!this._ensureAudio()) return;
    this.audioDecoder.decode(new EncodedAudioChunk({
      type: "key",
      timestamp: Math.round(ts * 1000000 / 48000),
      data: payload,
    }));
  }

  _play(data) {
    const buf = this.audioCtx.createBuffer(data.numberOfChannels, data.numberOfFrames, data.sampleRate);
    for (let ch = 0; ch < data.numberOfChannels; ch++) {
      const arr = new Float32Array(data.numberOfFrames);
      data.copyTo(arr, { planeIndex: ch, format: "f32-planar" });
      buf.copyToChannel(arr, ch);
    }
    data.close();
    const src = this.audioCtx.createBufferSource();
    src.buffer = buf;
    src.connect(this.audioCtx.destination);
    const now = this.audioCtx.currentTime;
    if (this._audioTime < now) this._audioTime = now + 0.01;  // 10 ms playout floor
    src.start(this._audioTime);
    this._audioTime += buf.duration;
  }
}
