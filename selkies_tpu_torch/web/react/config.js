// @ts-check
/**
 * URL-parameter connection config — parity with the reference React
 * client's config.ts:50-121 (?server=&port=&app=&secure=&debug= and the
 * turn_host/turn_port/turn_username/turn_password/turn_protocol group
 * that overrides the /turn fetch).
 */
"use strict";

/**
 * @typedef {Object} ConnectionConfig
 * @property {string} host
 * @property {number} port
 * @property {boolean} secure
 * @property {string} appName
 * @property {boolean} debug
 * @property {RTCIceServer[] | null} iceServers  overrides /turn when set
 */

/**
 * @param {Location} [loc]
 * @returns {ConnectionConfig}
 */
export function getConnectionConfig(loc = window.location) {
  const q = new URLSearchParams(loc.search);
  const serverParam = q.get("server");
  const portParam = q.get("port");
  const secureParam = q.get("secure");

  const secure = secureParam !== null
    ? secureParam === "true"
    : loc.protocol === "https:";
  const host = serverParam || loc.hostname;
  let port;
  if (portParam) {
    port = parseInt(portParam, 10);
  } else if (serverParam) {
    port = secure ? 443 : 80;       // external server, default ports
  } else {
    port = loc.port ? parseInt(loc.port, 10) : (secure ? 443 : 80);
  }

  let appName = q.get("app");
  if (!appName) {
    const parts = loc.pathname.split("/").filter((p) => p && p !== "react");
    appName = parts.pop() || "selkies-tpu";
    if (appName.includes(".")) appName = "selkies-tpu";  // index.html etc.
  }

  /** @type {RTCIceServer[] | null} */
  let iceServers = null;
  const turnHost = q.get("turn_host");
  if (turnHost) {
    const tPort = q.get("turn_port") ? `:${q.get("turn_port")}` : "";
    const proto = q.get("turn_protocol") || "udp";
    iceServers = [{
      urls: `turn:${turnHost}${tPort}?transport=${proto}`,
      username: q.get("turn_username") || undefined,
      credential: q.get("turn_password") || undefined,
    }];
  }

  return {
    host, port, secure, appName,
    debug: q.get("debug") === "true",
    iceServers,
  };
}

/**
 * Base ws/http URLs for a config.
 * @param {ConnectionConfig} cfg
 */
export function baseUrls(cfg) {
  const httpProto = cfg.secure ? "https:" : "http:";
  const wsProto = cfg.secure ? "wss:" : "ws:";
  const authority = `${cfg.host}:${cfg.port}`;
  return {
    http: `${httpProto}//${authority}`,
    ws: `${wsProto}//${authority}`,
  };
}
