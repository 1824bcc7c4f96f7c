/* PWA service worker: offline app-shell cache (reference: gst-web sw.js).
 * Static assets are cache-first with background refresh; the media
 * websocket and dynamic endpoints (/turn, /ws) bypass the cache. */
"use strict";

const CACHE = "selkies-tpu-v1";
const SHELL = [
  ".", "index.html", "app.js", "input.js", "media.js", "webrtc.js", "keysyms.js",
  "manifest.json",
];

self.addEventListener("install", (ev) => {
  ev.waitUntil(caches.open(CACHE).then((c) => c.addAll(SHELL)));
  self.skipWaiting();
});

self.addEventListener("activate", (ev) => {
  ev.waitUntil(
    caches.keys().then((keys) =>
      Promise.all(keys.filter((k) => k !== CACHE).map((k) => caches.delete(k)))
    )
  );
  self.clients.claim();
});

self.addEventListener("fetch", (ev) => {
  const url = new URL(ev.request.url);
  if (ev.request.method !== "GET" || url.pathname.endsWith("/turn") ||
      url.pathname.endsWith("/ws") || url.pathname.endsWith("/media")) {
    return;  // network only
  }
  ev.respondWith(
    caches.match(ev.request).then((hit) => {
      const refresh = fetch(ev.request)
        .then((resp) => {
          if (resp.ok) {
            const copy = resp.clone();
            caches.open(CACHE).then((c) => c.put(ev.request, copy));
          }
          return resp;
        })
        .catch(() => hit);
      return hit || refresh;
    })
  );
});
