/**
 * Typed interfaces for the shared protocol planes (loaded as classic
 * scripts from ../), mirroring the reference React client's typed
 * webrtc.ts/input.ts/signalling.ts surfaces (webrtc.ts:9-60).
 */

interface SelkiesStatsEvent {
  event?: "open" | "close" | "failed" | "redirect";
  reason?: string;
  [key: string]: unknown;
}

/** Server->client control message vocabulary (data channel / WS). */
interface SelkiesServerMessage {
  type?: string;
  [key: string]: unknown;
}

/** WS media plane (media.js): WebCodecs playback over /media. */
declare class SelkiesMedia {
  constructor(
    canvas: HTMLCanvasElement,
    onMessage: (msg: SelkiesServerMessage) => void,
    onStats: (ev: SelkiesStatsEvent) => void,
  );
  connect(url: string): void;
  send(msg: string): void;
  close(): void;
  connected: boolean;
  framesDecoded: number;
  keyFramesDecoded?: number;
  framesDropped: number;
  bytesReceived: number;
}

/** WebRTC media plane (webrtc.js): RTCPeerConnection + datachannel. */
declare class SelkiesWebRTC {
  constructor(
    videoEl: HTMLVideoElement,
    onMessage: (msg: SelkiesServerMessage) => void,
    onStats: (ev: SelkiesStatsEvent) => void,
  );
  connect(): Promise<void>;
  send(msg: string): void;
  close(): void;
  startLatencyProbe(
    onSample: (s: { brightness: number; intervalMs: number; t: number }) => void,
  ): () => void;
  stopLatencyProbe(): void;
  connected: boolean;
  framesDecoded: number;
  framesDropped: number;
  bytesReceived: number;
}

/** Input plane (input.js): keyboard/mouse/wheel/gamepad -> CSV protocol. */
declare class SelkiesInput {
  constructor(canvas: HTMLElement, send: (m: string) => void);
  canvas: HTMLElement;
  pointerLock: boolean;
  autoResize: boolean;
  remoteWidth: number;
  remoteHeight: number;
  attach(): void;
  detach(): void;
  requestPointerLock(): void;
  exitPointerLock(): void;
  enterFullscreen(): Promise<void>;
  pushClipboard(): void;
  noteRemoteClipboard(text: string): void;
}
