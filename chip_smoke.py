#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selkies_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --no-timing  # phases 1-9 and 12-21 only (a build-and-check run)

Phases, in order; any failure exits non-zero and prints no result:

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build the ME/MC, intra and BGRx->I420 kernels (nvcc, sm_90a), the native CAVLC
   packer and the frameprep library (g++) from the checkout's sources, all
   at once; print build seconds and the ``-Xptxas -v`` reports; read the
   ME/MC kernel's SASS
   (``cuobjdump -sass``) for the native 4-way byte SAD instruction that
   sets its operation floor;
3. hold the ME/MC kernel against its plain PyTorch version on the card at
   1920x1088 on three seeded cases (static, uniform motion, motion near the
   search reach with noise), on a tile-clamped candidate list, at a
   width whose last strip of 8 MBs is ragged (1376x768), and at the band
   path's 4K shapes: a 720x1920 tile of the 3x2 grid and a 720x3840 band,
   each on its reference slab, unclamped and clamped by 16-pixel halos,
   and the whole 2160x3840 frame; and the batched kernel (one launch over
   a session axis, each session with its own seeded motion and candidate
   list) against its batched plain version at 8 x 1088x1920 and at
   3 x 768x1376: every output exactly equal; and the intra kernel (the IDR
   step, one call) against its plain version at 1 and 8 x 1088x1920 with
   seeded QPs from 0 to 51: every output exactly equal; and the BGRx->I420
   kernel against its plain version at 8 x 1088x1920 and one frame;
4. the device-conversion path: TorchH264Encoder(1920, 1080,
   host_convert=False, pipeline_depth=0, frame_batch=1, device="cuda")
   over a seeded desktop-like trace
   (IDR, scrolls, typing, a static repeat, force_keyframe, a QP change)
   with the launch counters zeroed just before; every access unit's sha256
   must equal the same trace on the CPU, the kernel must have launched once
   per non-static P frame, the intra kernel once per IDR frame, the
   BGRx->I420 kernel once per IDR and non-static P frame, and the native
   packer at least once;
5. the host-conversion path, ungrouped and unpipelined:
   TorchH264Encoder(1920, 1080, scene_qp_boost=6, frame_batch=1,
   pipeline_depth=0, ltr_scenes=False, device="cuda") over a
   seeded 1080p desktop trace that produces every frame kind (IDR, static,
   delta with uploads, scene cut with the QP boost and pool seeding,
   another over-budget full P, remap-only delta, forced IDR over a static
   frame, forced IDR on a delta frame, a scroll of remaps + uploads, damage
   hints), counters zeroed just before; each kind is asserted from
   FrameStats and the link-byte counters, every AU's sha256 must equal the
   CPU run's, K1 must have launched once per non-static P frame, the native
   sparse packer at least once, and the frameprep library must be the one
   built from ``native/frameprep.cc``;
6. the registry row: TorchH264Encoder(1920, 1080, scene_qp_boost=6,
   device="cuda") with its defaults (groups of 4, pipeline depth 2, the LTR
   scene cache) over a seeded 1080p trace (IDR, a group of 4 typing
   deltas, a group of 2 closed by a static frame, a window switch with the
   scene cut, a typed delta carrying the long-term marking, two switches
   back that restore from the scene cache, a scroll of remaps and uploads,
   a forced IDR that clears the slots, another group), counters zeroed
   just before, every AU collected across submit and flush; the AUs must
   equal the CPU run's and an ungrouped, unpipelined card run's (LTR on),
   with ltr_restores >= 2, a group of 4 and one of 2 dispatched, K1 launched
   once per non-static P frame, the native sparse packer run and the up_*
   link bytes equal to the CPU run's;
7. the entropy plane at 1920x1080, qp 28, on the card, over a short seeded
   trace (IDR, a quiet typed line, a scene cut, two busy window scrolls, an
   LTR restore, a static frame, an entropy retune before a static frame and
   a typed line): (a) the registry row with device_entropy=True,
   bits_min_mbs=64 must give the registry row's own CAVLC AUs; (c) the row
   with entropy_coder="cabac", device_entropy=True must give (b)'s, the row
   with the host CABAC coder; (b) and (d), the device-conversion path with
   CABAC, must equal their CPU runs; the busy frames ship "bits" in (a) and
   "cabac" in (c), the quiet one "coeff"; the retune to CAVLC forces an IDR
   in (b) and (c); K1 launched once per non-static P frame in every card
   run and the native CABAC engine ran;
8. band and tile slicing (TorchBandedH264Encoder, selkies_tpu_torch/
   parallel/bands.py): (a) at 1920x1080 over a seeded full-motion trace
   (IDR, two busy scrolls, a window, its drag across the band seams, a
   static frame, a forced IDR), bands=4 (4 bands of 17 MB rows), bands=4
   with cols=2, and bands=4 with entropy_coder="cabac", device_entropy=True
   on light content: every AU's sha256 must equal the port's CPU run of the
   trace, K1 must launch bands x cols times per non-static P frame; (b) at
   3840x2160 on the card alone: cols=2, bands=3 (45x120-MB tiles) must give
   the AUs of bands=3, bands=1 those of TorchH264Encoder(frame_batch=1,
   pipeline_depth=0, ltr_scenes=False), and bands=4 must resolve to 3;
9. multi-session serving (TorchMultiSessionH264Service, selkies_tpu_torch/
   parallel/serving.py): (a) 8 sessions of 1920x1088, qp 28, over a seeded
   6-tick trace (an IDR tick, two P ticks where each session scrolls or
   types its own desktop, set_qp on two sessions and a forced keyframe on
   one, a mixed tick with two forced sessions, a P tick), counters zeroed
   just before: every session's AUs must equal a solo TorchH264Encoder
   (host_convert=False, frame_batch=1, pipeline_depth=0) fed the same
   frames, QPs and keyframes, K1 must launch exactly once per tick
   with a P session, the intra kernel once per tick with an IDR and the
   BGRx->I420 kernel once per tick; (b) the same trace at 4 x 640x368 must
   equal the port's CPU run of the service, with one BGRx->I420 launch a
   tick on the card and none on the CPU;
12. (run after phase 9, before the timing) the hybrid VP9/AV1 rows and the
   port's registry at 1920x1080, over a seeded desktop trace (the first
   frame, static repeats, typing, a 16-row scroll of a window, a window
   drag, a single-byte change to one channel, a forced keyframe): (a)
   DeviceDeltaFrontend on the card gives the CPU run's dirty maps and
   hints element for element, the one-byte change marks one MB and a
   static frame launches no coarse vote; (b) create_encoder("tpuvp9enc" /
   "tpuav1enc", frontend="device") on the card gives the AUs of the same
   row on the CPU by sha256 (VP9 with libvpx's row-mt off, since libvpx
   does not repeat its own bytes with it on; with it on, the active maps
   and static AUs equal), LibVpxDecoder decodes every VP9 AU, static
   frames are 1 byte (VP9) and 5 bytes (AV1, but the first repeat after a
   keyframe), and frontend "auto" resolves to the device front-end; a row
   whose library does not load prints ``{"row": ..., "skipped": ...}``;
   (c) create_encoder("tpuh264enc"), prewarmed, gives the AUs of
   TorchH264Encoder(frame_batch=4, pipeline_depth=2, scene_qp_boost=6)
   over a 1080p typing run, its first frame an IDR at frame_index 0, with
   K1 launched once per non-static P frame (counts zeroed after prewarm);
13. (run after phase 12, before the timing) the health and observability
   plane, all on the card with the port's own injector, tracer, telemetry
   and device pool: (a) create_encoder("tpuh264enc") over phase 12's
   typing trace with the tracer and telemetry off, then on, then on the
   CPU: the AUs sha256-equal in all three, ``classify`` once per submit,
   ``step`` / ``fetch`` / ``unpack`` / ``pack`` and the
   ``selkies_tile_cache_*`` counters as the CPU run's, K1 once per
   non-static P frame with the hooks on (counts zeroed just before), the
   chrome trace written to chiprun_out/phase13_trace.json; (b)
   ``frontend@4,9:raise`` on that row: exactly those submits raise, the
   other frames come out in order and equal the CPU run under the spec;
   (c) ``device:0@3:raise`` on TorchMultiSessionH264Service(8, 1920, 1088):
   tick 3 raises DeviceFault("0") with no tick in flight, note_tick_failure
   names the card at threshold 1, the other ticks equal the CPU run under
   the spec; TorchBandedH264Encoder(1920, 1080, bands=4) with device=None
   carves onto the card through the pool and, under
   ``device:0@every:1:flap`` at threshold 3, the card is quarantined from
   frame 3 on while the AUs equal phase 8's; after probation (an injected
   clock) pool.tick() runs the real probe on the card and readmits it on
   the third; the probe's ms; (d) DeviceMonitor reads the card's total
   and used memory;
14. (run after phase 13, before the timing) the fleet's device-facing
   layer, all on the card with the port's own pool, injector and telemetry,
   K1's counter zeroed just before each part: (a)
   TorchBandedFleetService(4, 1920, 1080, qp=28, bands=2) (the shared carve
   through the pool) over a seeded 8-tick full-motion trace (an IDR tick,
   P ticks where each session scrolls or types its own desktop, a static
   repeat for one session, set_qp on one, force_keyframe on another) with
   OccupancyScheduler.for_service: the AUs sha256-equal 4 solo
   TorchBandedH264Encoder(bands=2) card encoders, the trace at 4 x 640x384
   through the scheduler and with SELKIES_OCCUPANCY=0 (the serial tick)
   equal to the port's serial CPU run, K1 launched twice
   (bands) per non-static banded P frame; (b) checkpoint and re-carve of
   session 0 after tick 3 equal to an oracle forced a keyframe there,
   session 1 parked (b"", no IDR) and un-parked as a fresh IDR; (c)
   MixedTenancyService(TorchMultiSessionH264Service(4, 1920, 1088),
   TorchBandedFleetService(2, 1920, 1088, bands=2)): the AUs equal with
   occupancy off and on, K1 once per tick for the batch unit plus twice per
   banded P session; (d) ``sched:1@3:drop;sched:2@4:raise`` on (a)'s
   service: the dropped tick gives b"", the raising tick raises after the
   others ran, the two sessions then equal oracles that never saw those
   frames and every other session equals (a); (e) SessionPlacer(devices=None):
   the shared carve on the pool's one card, an accepted admission, and a
   DrainController drain (the service's force-keyframe, flush and hand-off)
   with a checkpoint per session inside its deadline;
15. (run after phase 14, before the timing) the tile-column codec mesh,
   the library rows and the software fleet, on the card, K1's counter
   zeroed just before each part: (a) MeshDeltaFrontend(1920, 1080, cols)
   at cols 1, 2, 4 and 7 (7 pads 1920 to 2016 px) over phase 12's trace
   (a reset at its keyframe): every dirty map and hint list equals the
   port's CPU run element for element, static steps vote too, and cols=1's
   maps equal DeviceDeltaFrontend's; (b) create_encoder("tpuvp9enc" /
   "tpuav1enc", cols=2, frontend="device"): where the library loads the
   AUs sha256-equal the CPU run's (VP9 with row-mt off), else
   ``{"row": ..., "skipped": ...}`` or JAX's degrade (tpuav1enc without
   libaom serves tpuh264enc); (c) x264enc, x265enc, nvh265enc and svtav1enc
   over phase 12's typing run: with the library missing each serves
   tpuh264enc, its AUs equal create_encoder("tpuh264enc") with the same
   knobs and K1 launches once per non-static P frame; with it loaded, the
   frame kinds and byte counts; (d) SoftwareFleetService(4, 1920, 1080)
   over a 6-tick trace (an IDR tick, P ticks, set_qp on one session,
   force_keyframe on another): degraded to solo encoders, each session's
   AUs equal a solo registry-row encoder fed the same frames, QPs and
   keyframes, K1 once per non-static P session a tick; (e)
   TorchBandedFleetService(2, 1920, 1080, bands=2, codecs=["h264", "av1"]),
   then set_codec(1, "vp9") + recarve: the session builds its tile-column
   row, or degrades to h264 with the record reset, its AUs equal the
   matching oracle's, and the fleet's own ticks (counted around each tick,
   not the oracle's) launch K1 bands x cols times per non-static banded P
   session;
16. (run after phase 15, before the timing) the solo serving app,
   TorchWebRTCApp (selkies_tpu_torch/pipeline/app.py) with device=None (the
   card), every encoder it builds recorded (each call that feeds or steers
   the stream, with what it returned): (a) SyntheticSource(1920, 1080),
   the registry's tpuh264enc row, 60 fps, 8000 kbps, served until 120
   frames went out, then stopped and its encoder flushed: the first AU an
   IDR with a 1920x1080 SPS, the sent AUs the head of what the encoder
   returned, a direct card row fed the logged calls (frames, QPs,
   timestamps, damage) gives the same AUs, its first 13 equal the CPU's
   replay, and K1 launched once per non-static P frame (the prewarm's
   apart); (b) the recovery ladder on the flat row under
   ``encoder@9-14,21-32,39-50,57-68:raise`` with the supervisor's clock
   frozen: a restart, degrade levels 1 (half the framerate), 2 (960x528)
   and 3 (the x264enc row, which without libx264 serves tpuh264enc with the
   registry's warning), then the reversal to 1920x1080 at 60 fps; each of
   the six encoders starts with an SPS of its size, equals its card replay,
   launches K1 once per non-static P frame, and the device memory at each
   build is printed; (c) (a) again with SELKIES_POLICY=1 and SELKIES_SLO=1:
   the replays equal (a replaced encoder's AUs the head of its replay's),
   the engine's and the SLO plane's stats; (d) (with the timing) the app
   at 60 and 30 fps, hooks off: 4 s of steady state each, delivered fps,
   capture->send ms (median, p95) from stamps on the source and the
   transport, dropped ticks and frames, the device's idle share over a few
   ticks (torch.profiler), and the same registry row fed the source's
   frames back to back (fps, submit->AU ms);
17. (run after phase 16, before the timing) the fleet's serving core,
   SessionFleet (selkies_tpu_torch/parallel/fleet.py) with the card
   taken through the device pool (devices=None), its slots' WebSocket
   planes recorders: (a) 8 slots of 1920x1088 at 60 fps (bands 1: the
   batch service) fed phase 14's desktop trace, 4 ticks by
   _capture_batch + _encode_tick (the IDR tick, a forced keyframe and a
   bitrate retune): the AUs equal a direct TorchMultiSessionH264Service
   fed the same batches and the slots' QPs, the same fleet at 4 x 640x368
   equals the CPU's, K1 launches once per tick with a P session (read
   around _encode_tick); (b) the live loop (start / _run / stop) over 8
   slots of 1920x1088 at a 60 fps tick, sources cycling through 12
   frames of phase 9's desktops, 4 s of steady state in one pair of runs,
   occupancy on then SELKIES_OCCUPANCY=0: delivered fps across sessions,
   on_tick's tick ms and capture->send ms (median, p95; stamps on the
   source and the plane), the supervisor's failures (0), device ops and
   idle share over 5 ticks (torch.profiler), and the direct service's P
   tick ms from the replay of the same run (the yardstick: the loop's
   share of N x its ticks per second); the service is wrapped to record
   each call, and every tick and sent AU equals that replay; the first run
   idles 1 s with no slot connected first, with no K1 launch and no
   service call; (c) SELKIES_BANDS=2, 4 slots of 1920x1080
   (TorchBandedFleetService), occupancy on, 6 ticks: the AUs equal a
   direct banded service's, K1 twice per non-static banded P session a
   tick; negotiate_session(0, ["av1", "h264"]) settles on what
   negotiate.resolve gives (h264 without libaom) and the session keeps
   serving; (d) the ladder at 4 x 640x384 under ``encoder@3-26:raise``
   with the supervisor's clock frozen: force-IDR, a restart, degrade
   levels 1-3 (half and quarter fps, the software service) and the
   reversal, each service the fleet builds recorded (its build ms, the ms
   to its first AU, its K1 launches) and equal to its replay; (e)
   dryrun(8) on the card;
18. (run after phase 17, before the timing) the solo server: (a)
   ``Orchestrator(cfg, device="cuda")`` (selkies_tpu_torch/orchestrator.py)
   on the tpuh264enc row at 1920x1080 over the synthetic source (no
   display), 60 fps, 8000 kbps, port 0, telemetry and the metrics
   exporter on; an aiohttp client on /media reads 3.5 s of video: the first
   frame is a keyframe with its SPS; every encoder call is recorded, and a
   direct card row fed the log gives every AU (sha256), the received ones
   its head; K1 launched once per non-static P frame the row coded, and on
   one of the session's P frames its output equals its plain version on
   the same inputs; keyboard and mouse messages reach the FakeBackend the
   server opened; ``vb,6000`` retunes the rate controller and lands in
   the JSON overlay; /healthz answers 200, /statz JSON, the exporter the
   selkies_ families and the parity gauges; delivered fps and
   capture->send ms (median, p95; stamps on the source and the mux) over
   a steady window, dropped ticks and captures, and the device's idle
   share over 10 ticks (torch.profiler); (b) ``python3 -m
   selkies_tpu_torch --addr 127.0.0.1 --port <free> --capture_width 1920
   --capture_height 1080 --json_config <tmp>`` as a subprocess (its log in
   chiprun_out/phase18_server.log): /healthz, 30 frames over /media (the
   first a keyframe), the seconds from the process start to the first AU;
   then SIGTERM: /healthz 503 "draining" while it drains, an IDR reaches
   the client, and the process exits 0 within 120 s;
19. (run after phase 18, before the timing) the solo server over WebRTC:
   the same server with GCC on, its STUN server a silent loopback socket
   (srflx gathering fails as it does offline; no outside host is
   contacted); ``RtcBrowser`` (the port's IceAgent, DTLS client, SRTP,
   SCTP client, RecoveringReceiver and H264Depayloader, sending NACKs,
   TWCC feedback and receiver reports) sends HELLO 1 on /ws, answers the
   offer, trickles 127.0.0.1 and opens ``input``. (a) A clean link: the
   delivered AUs are the head of what the recorded row returned, the first
   a keyframe with its SPS; the row's replay on a direct card row equal;
   K1 once per non-static P frame and equal to its plain version on a
   session P frame; input over the data channel reaches the FakeBackend;
   codec / system / ping / system_stats / gpu_stats arrive over the data
   channel and no frame over /media; two PLIs inside the throttle force one
   IDR; a NACK is answered by the same datagram; TWCC feedback reaches GCC.
   Recorded: the signalling, ICE and DTLS seconds, what ICE gathered,
   delivered fps, capture-to-send and capture-to-browser ms (median, p95),
   packets per AU and per second with the FEC share, host us per packet in
   ``PeerConnection._send_rtp``, GCC's estimate and the device's idle
   share over 10 ticks. (b) The browser leaves with an RTCP BYE; under
   ``net:loss@p:0.02,seed:3:drop`` a second browser gets a fresh peer and
   handshake, a keyframe first, every complete AU equal to the row's AU
   of its RTP timestamp, and retransmissions for its NACKs; the freezes,
   the ladder's rung and the fps are recorded;
20. (run after phase 19, before the timing) the fleet server and the
   cluster plane: (a) ``FleetOrchestrator`` as ``main(["--tpu_sessions",
   "8", ...])`` builds it on the card (devices=None), 8 sessions of
   1920x1088 at 60 fps and 8000 kbps, the batch service with occupancy at
   its default, the synthetic sources (no display), STUN a silent
   loopback socket; seven aiohttp clients on /media/0-6 and an RtcBrowser
   on session 7 (HELLO 71). Every session's received AUs are a run of its
   recorded service ticks (a keyframe with its SPS among the first two);
   the recorded ticks equal their replay on a direct card service, the
   first two the CPU's, and so do the first and the last tick after a QP
   change and the drain's IDR tick, each coded on the CPU from the card
   replay's state before it (its reference planes after it compared too);
   the supervisor counts no failure; K1 launches once per tick with a P
   session and its plain versions never run
   (``launches_fleet_server_path``), the BGRx->I420 kernel once per
   dispatched tick, and on one tick's inputs K1 equals
   ``me_mc_batch_plain``; fps across sessions
   over 3 s (its share of phase 17 (b)'s occupancy-on loop), capture->send
   ms (median, p95) and the idle share over 10 ticks (torch.profiler);
   then the drain with no cluster: every client sees an IDR after it
   began and the 8 sessions are handed off as checkpoints. (b) Two fleet
   servers of 2 x 1920x1088 on the one card, each built with
   SELKIES_CLUSTER_SELF / _PEERS naming the other, SELKIES_CLUSTER_SECRET
   set (signed heartbeats, HttpMigrationChannel) and heartbeats every
   0.25 s: a client with signalling (HELLO 1) and /media/0 on host A;
   A drains; the session ships to B, the client follows the REDIRECT to
   B's /ws and /media/<landing>; B's first AUs of the session, the first
   the recovery IDR, equal the card's uninterrupted oracle (A's recorded
   calls replayed into one direct service that then codes B's frames at
   B's QPs); K1, counted from 0 over both hosts, launches once per tick
   with a P session on A and B and its plain versions never run
   (``launches_cluster_path``). Recorded: heartbeat -> alive s, ship ->
   ack ms, checkpoint -> B's first AU ms and redirect -> the client's first AU ms;
21. (run after phase 20, before the timing) the multi-card carve, each part
   on k distinct cards where the machine has them, else on cuda:0 listed k
   times (printed, with the device of every band's reference planes):
   (a) TorchBandedH264Encoder(devices=...) at 1920x1080 bands=4, the 2x2
   grid at 1920x1080 and the 3x2 grid at 3840x2160 over a seeded trace
   (IDR, 4 full-motion P frames, a static repeat, a forced IDR, a QP
   change): every AU's sha256 equals the stacked path's on cuda:0, K1
   launches bands x cols times per non-static P frame; recorded: step and
   device ms per frame kind against the stacked path, the bytes each P
   frame exchanges between shards and (with the timing) the device ops
   and idle share over 4 P frames of each (torch.profiler); (b)
   MeshDeltaFrontend at cols 2 and 4 on phase 15 (a)'s frames: maps and
   hints equal the one-card front-end's; (c)
   TorchMultiSessionH264Service(8, 1920, 1088) in 2 groups over phase 9's
   ticks (IDR, P, mixed, QP changes): every session's AUs equal phase 9's
   one-card service's, K1 launches once per group and tick with a P
   session, the BGRx->I420 kernel once per group and tick, and the P
   tick's split is recorded. K1's plain versions never
   run in the phase;
10. time the kernel with CUDA events over 50 launches queued behind a spin
   kernel (the device's time; also as the host issues them), its plain
   version, the device-conversion encoder per frame for IDR and P, the
   host-conversion encoder's median FrameStats split per frame kind
   (classify / convert / h2d / step / fetch / unpack / cavlc ms, up and
   down bytes), and with torch.profiler the device's busy and idle share
   over IDR, P and delta-P frames; over a 1080p typing run, the registry
   row against frame_batch=1, pipeline_depth=0 (and each knob alone, one
   run each): frames per second, median
   and p95 latency from a frame's submit() call to the return of the call
   that hands back its AU, the FrameStats split, and the device idle share
   over 8 grouped typing deltas; for each coder with device entropy off
   and on, the FrameStats split and down bytes of 1080p full-P and
   window-scroll delta frames, the device-entropy downlink alone by CUDA
   events at the top bucket and at the smallest bucket that holds the
   frame, and the device op count and idle share of those frames
   (torch.profiler); on the 1080p full-motion trace, the median
   FrameStats split per frame kind (step, per-band step min/max, fetch,
   unpack, pack, AU, up and down bytes) of the flat solo encoder, bands=4,
   a 2x2 grid and the 4K 3x2 grid, and the device ops and idle share of
   solo and bands=4 P frames (torch.profiler); the multi-session service
   at 1, 2, 4 and 8 sessions of 1920x1088 on full motion: the IDR tick,
   the median split of 4 P ticks (convert / h2d / dispatch / step / fetch /
   pack ms), frames per second, a mixed tick with one IDR, the device ops
   and idle share per P tick (torch.profiler over 2; an 8-session tick must issue
   at most 1.25x the 1-session tick's ops) and peak device memory; the
   same frames through 8 solo flat encoders in turn; and the batched
   kernel at 8 x 1088x1920 by CUDA events against its byte bound; the
   intra kernel at 1 and 8 x 1088x1920 by CUDA events (20 calls behind a
   spin kernel, and as issued) against its byte floor and its 187-step
   chain, its plain version, and row 0 and one MB column alone; the
   BGRx->I420 kernel at 8 x 1088x1920 and one frame by CUDA events (50
   launches behind a spin kernel, and as issued) against its byte bound,
   and its plain version; the hybrid front-end step per frame kind (static, typing, scroll, full; host
   clock around the synchronised step), its upload (host clock and CUDA
   events), its device ops and idle share over 8 steps (torch.profiler),
   FramePrep.dirty_tiles on the same frames, and the VP9/AV1 rows' median
   per-frame split (front-end, library, conversion ms, AU bytes) per frame
   kind with the device and the host front-end; the registry row's typing
   run with the tracer and telemetry off and on, in turns (off, on, on,
   off): frames per second, median and p95 latency, the span counts and
   median ms per span name, and the probe's ms; the fleet (phase 14's (a)
   and (c) configurations on full motion, with the card's name and power
   limit): occupancy off and on on one service in one pair
   of 6 P ticks (median tick ms, fps across sessions, the dispatch and
   complete ms per unit, the scheduler's overlap and sched_wait per
   session), the device ops and idle share per tick (torch.profiler over
   3 ticks each way), and the ms from a checkpoint to the first AU after a
   re-carve; MeshDeltaFrontend's step per frame kind at cols 1, 2 and 4
   against DeviceDeltaFrontend (host clock around the synchronised step)
   with device ops and idle share over 8 static and 8 changed steps
   (torch.profiler), and SoftwareFleetService(4, 1920, 1080)'s IDR tick,
   median P tick and fps across sessions on full motion (phase 15 (d)'s
   service, 6 more ticks);
11. print the ``{"kernels": [...]}`` line (K1 at the solo shape and as the
    8-session launch, the intra kernel at 1 and 8 sessions, with its
    launches on every path, the fleet's, the library rows' degrade, the
    software fleet's, the serving app's, the fleet loop's, the solo
    server's, the WebRTC session's and the fleet server's included), then
    the ``{"ok": true, ...}`` line.

The full record is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

W, H = 1920, 1080
# H100 SXM published peaks: HBM 3.35 TB/s, 67 TFLOP/s fp32. int32 has no
# published peak: 64 int32 lanes per SM x 132 SMs x 1.98 GHz (the clock that
# gives 67 TFLOP/s fp32 from 128 fp32 lanes per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _planes(h, w, seed, motion, noise, dev):
    import torch

    rng = np.random.default_rng(seed)
    # blocky content with texture: coarse voting finds the global motion
    cur = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8), np.int64))
    cur = np.clip(cur + rng.integers(-20, 21, cur.shape), 0, 255)
    ref = np.roll(cur, motion, (0, 1))
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(cur.astype(np.int32)), t(ref), t(cu), t(cv)


def _me_inputs(case, dev):
    """case: (seed, motion, noise[, (h, w)[, _refine_cands clamps]])."""
    from selkies_tpu_torch.models.h264 import encoder_core as core

    seed, motion, noise, *rest = case
    (h, w), clamp = (rest + [(1088, 1920), {}][len(rest):])
    cur, ref, cu, cv = _planes(h, w, seed, motion, noise, dev)
    pads = [core.edge_pad(p, core.MV_PAD) for p in (ref, cu, cv)]
    cands = core._refine_cands(core.coarse_vote_candidates(cur, ref), **clamp)
    return (cands, cur, *pads)


def _slab_me_inputs(case, dev):
    """case: (seed, motion, noise, (fh, fw), (r0, c0, h, w), (halo, halo_cols)).
    The kernel's inputs for the (h, w) tile at (r0, c0) of an (fh, fw)
    frame as the band and tile steps build them (encode_tile_p_planes): a
    reference slab of ``halo`` real rows and ``halo_cols`` real columns
    round the tile (chroma: half; 0 takes the whole axis), clipped at the
    picture's edges, edge-padded out to MV_PAD, and the candidate window
    clamped to ``halo - 2`` on an axis whose halo is below the full reach."""
    import torch

    from selkies_tpu_torch.models.h264 import encoder_core as core

    seed, motion, noise, (fh, fw), (r0, c0, h, w), (halo, hc) = case
    cur, ref, cu, cv = _planes(fh, fw, seed, motion, noise, dev)

    def axis(n, start, size, hv):
        if hv == 0:
            return torch.arange(n, device=dev)
        return torch.arange(start - hv, start + size + hv, device=dev).clamp(0, n - 1)

    def slab(p, s):
        hv, hh = halo >> s, hc >> s
        rows, cols = axis(p.shape[0], r0 >> s, h >> s, hv), axis(p.shape[1], c0 >> s, w >> s, hh)
        sl = p.index_select(0, rows).index_select(1, cols)
        vt, ht = core.MV_PAD - hv, core.MV_PAD - hh
        return core.edge_pad(sl, vt, vt, ht, ht)

    full_reach = core.COARSE_DS * core.COARSE_R + core.REFINE_R + 2
    clamp = {k: (None if v == 0 or v >= full_reach else v - 2)
             for k, v in (("dy_max", halo), ("dx_max", hc))}
    tile = cur[r0:r0 + h, c0:c0 + w]
    cands = core._refine_cands(
        core.coarse_vote_candidates(tile, ref[r0:r0 + h, c0:c0 + w]), **clamp)
    return (cands, tile.contiguous(), slab(ref, 0), slab(cu, 1), slab(cv, 1))


def _sass_check(lib_path: Path, nvcc: str) -> dict:
    """Count the kernel's native 4-way byte SAD instructions (VABSDIFF4) in
    its SASS. Each instantiation's SAD loop is unrolled over one 16x16
    block: 64 of them means one instruction per 4 pixels and candidate."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs = out.split("Function : ")[1:]
    per_kernel = [f.count("VABSDIFF4") for f in funcs]
    if not per_kernel:
        _fail("cuobjdump shows no kernel in the ME/MC library")
    # the opcode mix of the 16-byte-aligned instantiation (the main path's)
    vec = next((f for f in funcs if "ILb1E" in f.split()[0]), funcs[0])
    mix = {op: len(re.findall(rf"\b{op}[.\s]", vec)) for op in
           ("VABSDIFF4", "SHF", "LDS", "IADD3", "LDGSTS", "STG", "BAR")}
    return {"vabsdiff4_per_kernel": per_kernel, "native_simd4": min(per_kernel) == 64,
            "opcodes_vec_kernel": mix}


def _desktop_trace():
    """Seeded 1080p BGRx desktop trace: block wallpaper with text-like rows,
    two scrolls, a typing patch, a static repeat, a pan, a window change."""
    rng = np.random.default_rng(2026)
    base = np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))
    base = base[:H]
    glyphs = rng.integers(0, 2, (H // 4, W // 2, 1), np.uint8) * 180
    base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    frames = [base]
    cur = base
    for dy in (16, 24):  # scrolls
        cur = np.roll(cur, -dy, 0)
        frames.append(cur)
    cur = cur.copy()
    cur[500:516, 300:900, :3] = rng.integers(0, 255, (16, 600, 3), np.uint8)  # typing
    frames += [cur, cur.copy()]  # then a static repeat
    frames.append(np.roll(cur, (6, -10), (0, 1)))  # pan (the IDR is forced here)
    frames.append(np.roll(frames[-1], 12, 1))  # QP change here
    win = frames[-1].copy()
    win[200:700, 400:1400] = rng.integers(0, 255, (500, 1000, 4), np.uint8)
    frames.append(win)
    return frames


def _drive(enc, frames):
    """-> [(sha256, FrameStats)] with force_keyframe at 5 and qp 34 at 6."""
    out = []
    for i, f in enumerate(frames):
        if i == 5:
            enc.force_keyframe()
        (au, stats, _), = enc.submit(f, qp=34 if i == 6 else None)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"frame {i}: access unit is not Annex-B")
        out.append((hashlib.sha256(au).hexdigest(), stats))
    return out


def _host_frames(seed: int):
    """1080p BGRx building blocks of the host-conversion traces: a block
    wallpaper, a 1024x528 tile-aligned window of new content over it, the
    wallpaper with a typed line, and the window scrolled up 16 rows with a
    new line at its bottom."""
    rng = np.random.default_rng(seed)
    a = np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))[:H]
    a[::4, ::3, :3] = rng.integers(0, 255, a[::4, ::3, :3].shape, np.uint8)
    win = a.copy()
    win[192:720, 384:1408] = rng.integers(0, 255, (528, 1024, 4), np.uint8)
    typed = a.copy()
    typed[500:516, 300:700, :3] = 255 - typed[500:516, 300:700, :3]
    scrolled = win.copy()
    scrolled[192:704, 384:1408] = win[208:720, 384:1408]
    scrolled[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
    return a, win, typed, scrolled


# the frame kinds of the host-conversion path, as _host_kind names them
HOST_KINDS = ("idr", "static", "delta_upload", "scene_cut_seed", "full_seed", "remap_only",
              "idr_resident", "idr_delta", "delta_mixed")
BOOST = 6


def _host_trace():
    """-> [(frame, op, damage, expected kind)] producing every kind."""
    a, win, typed, scrolled = _host_frames(2027)
    patched = win.copy()
    patched[900:916, 100:300, :3] = 9
    scrolled = scrolled.copy()
    scrolled[900:916, 100:300, :3] = 9
    cursor = scrolled.copy()
    cursor[60:76, 1500:1512, :3] = 250
    return [
        (a, None, None, "idr"),
        (a.copy(), None, None, "static"),
        (typed, None, [(300, 500, 400, 16)], "delta_upload"),
        (win, None, None, "scene_cut_seed"),
        (typed.copy(), None, None, "full_seed"),
        (win.copy(), None, None, "remap_only"),
        (win.copy(), "idr", None, "idr_resident"),
        (patched, "idr", None, "idr_delta"),
        (scrolled, None, None, "delta_mixed"),
        (cursor, None, [(1500, 60, 12, 16), (0, 0, 2, 2)], "delta_upload"),
        (cursor.copy(), None, [], "static"),
    ]


def _host_kind(prev_links: dict, links: dict, st, base_qp: int) -> str:
    """A host-path frame's kind from its FrameStats and the link-byte
    counters' growth over the frame."""
    grew = {k for k, v in links.items() if v != prev_links.get(k, 0)}
    if st.idr:
        if not grew & {"up_full", "up_delta"}:
            return "idr_resident"
        return "idr_delta" if "up_delta" in grew else "idr"
    if st.upload_kind == "static":
        return "static"
    if st.upload_kind == "full":
        if "up_seed" not in grew:
            return "full"
        return "scene_cut_seed" if st.scene_cut and st.qp == base_qp + BOOST else "full_seed"
    if st.remap_frac == 1.0:
        return "remap_only"
    return "delta_upload" if st.remap_frac == 0.0 else "delta_mixed"


def _drive_host(enc, trace, base_qp=28):
    """-> [(sha256, FrameStats, kind, up bytes, down bytes)]."""
    out = []
    prev = enc.link_bytes.snapshot()
    for i, (frame, op, damage, _) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        (au, st, _), = enc.submit(frame, damage=damage)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"host frame {i}: access unit is not Annex-B")
        links = enc.link_bytes.snapshot()
        grown = {k: v - prev.get(k, 0) for k, v in links.items()}
        out.append((hashlib.sha256(au).hexdigest(), st, _host_kind(prev, links, st, base_qp),
                    sum(v for k, v in grown.items() if k.startswith("up_")),
                    sum(v for k, v in grown.items() if k.startswith("down_"))))
        prev = links
    return out


def _host_timing_trace(rounds: int):
    """Rounds of every kind for the per-kind timing: a new wallpaper each
    round (forced IDR, static), four typed lines one after another (the
    first re-codes the IDR's quantisation tail, the next three are steady
    typing deltas), a forced IDR over the static screen, a window over it
    (full P with seeding), the typed screen and the window again (remaps),
    the window scrolled (remaps + uploads), a forced IDR on a delta frame."""
    trace = []
    for r in range(rounds):
        a, win, _, scrolled = _host_frames(100 + r)
        typed = [a]
        for k in range(4):
            t = typed[-1].copy()
            rows = slice(400 + 32 * k, 416 + 32 * k)
            t[rows, 300:700, :3] = 255 - t[rows, 300:700, :3]
            typed.append(t)
        patched = typed[-1].copy()
        patched[900:916, 100:300, :3] = 9
        trace += [(a, "idr", None, ""), (a.copy(), None, None, "")]
        trace += [(t, None, None, "") for t in typed[1:]]
        trace += [(typed[-1].copy(), "idr", None, ""), (win, None, None, ""),
                  (typed[-1].copy(), None, None, ""), (win.copy(), None, None, ""),
                  (scrolled, None, None, ""), (patched, "idr", None, "")]
    return trace


def _type(frame, rng, row: int, col: int, width: int = 400):
    """A copy of ``frame`` with one 16-row line of glyph noise typed in."""
    f = frame.copy()
    f[row:row + 16, col:col + width, :3] = rng.integers(0, 255, (16, width, 3), np.uint8)
    return f


def _registry_trace():
    """-> [(frame, op)], 19 frames at 1080p: desktop A (IDR), four typing
    deltas (a group of 4), two more (a group of 2) closed by a static frame,
    a switch to desktop B (A under a 1024x528 window: the scene cut), a
    line typed in B's window (its slice carries B's long-term marking),
    back to A's last capture and to B's (two restores from the scene
    cache), two 16-row scrolls of the window (remaps plus a new line of
    uploads), a forced IDR on the static screen (it clears the slots) and
    four typing deltas after it."""
    a, win, _, _ = _host_frames(2028)
    rng = np.random.default_rng(2029)
    typing = [a]
    for k in range(6):
        typing.append(_type(typing[-1], rng, 300 + 32 * k, 200))
    b_typed = _type(win, rng, 400, 500)
    scrolls = [b_typed]
    for _ in range(2):
        s = scrolls[-1].copy()
        s[192:704, 384:1408] = scrolls[-1][208:720, 384:1408]
        s[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
        scrolls.append(s)
    after = [scrolls[-1]]
    for k in range(4):
        after.append(_type(after[-1], rng, 900, 100 + 400 * k))
    return ([(a, None)] + [(f, None) for f in typing[1:]] + [(typing[-1].copy(), None)]
            + [(win, None), (b_typed, None), (typing[-1], None), (b_typed, None)]
            + [(f, None) for f in scrolls[1:]] + [(scrolls[-1].copy(), "idr")]
            + [(f, None) for f in after[1:]])


def _drive_registry(enc, trace):
    """Every AU of the trace, collected across submit() and flush() ->
    ([(sha256, FrameStats)] in frame order, up_* link bytes)."""
    outs = []
    for i, (frame, op) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        outs += enc.submit(frame, meta=i)
    outs += enc.flush()
    if [m for *_, m in outs] != list(range(len(trace))):
        _fail(f"registry path returned frames {[m for *_, m in outs]}")
    if not all(au.startswith(b"\x00\x00\x00\x01") for au, *_ in outs):
        _fail("registry path: an access unit is not Annex-B")
    ups = {k: v for k, v in enc.link_bytes.snapshot().items() if k.startswith("up_")}
    return [(hashlib.sha256(au).hexdigest(), st) for au, st, _ in outs], ups


def _typing_run(n: int, seed: int):
    """Desktop A, then n frames each typing one more line somewhere on it."""
    a, *_ = _host_frames(seed)
    rng = np.random.default_rng(seed + 1)
    frames = [a]
    for i in range(n):
        frames.append(_type(frames[-1], rng, 64 + 16 * (i % 60), 100 + (i * 37) % 1200))
    return frames


def _time_typing(cfg: dict, frames, warm: int, hooks: bool = False) -> dict:
    """Frames per second, per-frame latency (a frame's submit() call to the
    return of the call that hands back its AU) and the median FrameStats
    split over frames[1 + warm:], after an IDR and ``warm`` deltas, on a
    fresh encoder of configuration ``cfg``. The frames are submitted back to
    back, not paced to a capture rate. With ``hooks`` the tracer and the
    telemetry bus are on over the timed frames, and the span counts, their
    medians and the tracer's summary are returned too."""
    import torch
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.monitoring.tracing import tracer

    enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **cfg)
    for f in frames[:1 + warm]:
        enc.submit(f)
    enc.flush()
    torch.cuda.synchronize()
    _set_hooks(hooks)
    t_sub, lat, stats = {}, {}, {}

    def take(outs):
        now = time.perf_counter()
        for _, st, m in outs:
            lat[m], stats[m] = (now - t_sub[m]) * 1e3, st
    t0 = time.perf_counter()
    for i, f in enumerate(frames[1 + warm:]):
        t_sub[i] = time.perf_counter()
        take(enc.submit(f, meta=i))
    take(enc.flush())
    wall = time.perf_counter() - t0
    enc.close()
    spans = (_span_counts(), _span_medians(), tracer.summary()) if hooks else None
    _set_hooks(False)
    n = len(t_sub)
    if len(lat) != n or any(st.upload_kind != "delta" for st in stats.values()):
        _fail(f"typing run {cfg}: {len(lat)} of {n} frames, kinds "
              f"{sorted({st.upload_kind for st in stats.values()})}")
    lats = sorted(lat.values())
    out = {"frames": n, "fps": n / wall, "latency_ms_median": statistics.median(lats),
           "latency_ms_p95": lats[-(-95 * n // 100) - 1], "latency_ms_max": lats[-1],
           "group_sizes": dict(enc.group_sizes)}
    for k in ("classify_ms", "convert_ms", "h2d_ms", "upload_ms", "step_ms", "fetch_ms",
              "unpack_ms", "cavlc_ms", "pack_ms", "device_ms", "bytes"):
        out[k] = statistics.median(getattr(st, k) for st in stats.values())
    if spans is not None:
        out["span_counts"], out["span_median_ms"], out["span_summary"] = spans
    return out


def _overlay(base, lift: int = 24):
    """``base`` under a dialog backdrop that lightens a 1280x432 region by
    ``lift``: 270 dirty tiles, over the delta budget, so a full P frame
    whose coded slice stays within the token cap."""
    w = base.copy()
    w[224:656, 320:1600, :3] = np.clip(base[224:656, 320:1600, :3].astype(np.int16) + lift,
                                       0, 255).astype(np.uint8)
    return w


def _scroll_window(frame, rng):
    """The backdrop region of ``frame`` scrolled up 16 rows, a new row of
    16x16 blocks at its bottom."""
    s = frame.copy()
    s[224:640, 320:1600] = frame[240:656, 320:1600]
    s[640:656, 320:1600] = np.kron(rng.integers(30, 250, (1, 80, 4), np.uint8),
                                   np.ones((16, 16, 1), np.uint8))
    return s


def _block_wallpaper(rng):
    """A 1080p wallpaper of flat 16x16 blocks: its IDR leaves no
    quantisation tail for the next P frames to re-code."""
    return np.kron(rng.integers(30, 220, (68, 120, 4), np.uint8), np.ones((16, 16, 1), np.uint8))[:H]


def _entropy_trace():
    """-> [(frame, op)], 10 frames at 1080p: desktop A (IDR), two typed
    lines (quiet deltas), a dialog backdrop over A (a full-P scene cut),
    two 16-row scrolls of the backdrop region (busy deltas), back to the
    typed A (an LTR restore), a static frame, then ("switch": flush and
    retune the entropy knobs first) the static screen again and a third
    typed line."""
    rng = np.random.default_rng(2031)
    a = _block_wallpaper(rng)
    a1 = _type(a, rng, 304, 208)  # MB-aligned lines of 25 MBs
    a2 = _type(a1, rng, 352, 208)
    scrolls = [_overlay(a2)]
    for _ in range(2):
        scrolls.append(_scroll_window(scrolls[-1], rng))
    return [(a, None), (a1, None), (a2, None), (scrolls[0], None), (scrolls[1], None),
            (scrolls[2], None), (a2, None), (a2.copy(), None), (a2.copy(), "switch"),
            (_type(a2, rng, 400, 208), None)]


def _drive_entropy(enc, trace, switch: dict):
    """Every AU of the trace, collected across submit() and flush(); before
    a "switch" frame the encoder is flushed and ``retune_entropy(**switch)``
    called. -> ([(sha256, FrameStats)] in frame order, the retune's answer,
    K1 launches, LTR restores)."""
    from selkies_tpu_torch.models.h264 import me_mc

    me_mc.launches = 0
    outs, answer = [], None
    for i, (frame, op) in enumerate(trace):
        if op == "switch":
            outs += enc.flush()
            answer = enc.retune_entropy(**switch)
        outs += enc.submit(frame, meta=i)
    outs += enc.flush()
    launches = me_mc.launches
    enc.close()
    if [m for *_, m in outs] != list(range(len(trace))):
        _fail(f"entropy path returned frames {[m for *_, m in outs]}")
    if not all(au.startswith(b"\x00\x00\x00\x01") for au, *_ in outs):
        _fail("entropy path: an access unit is not Annex-B")
    rows = [(hashlib.sha256(au).hexdigest(), st) for au, st, _ in outs]
    p = sum(1 for _, st in rows if not st.idr and st.upload_kind != "static")
    if enc.device.type == "cuda" and launches != p:  # the CPU runs the plain version
        _fail(f"me_mc launched {launches} times for {p} non-static P frames (entropy path)")
    return rows, answer, launches, enc.ltr_restores


def _entropy_timing_frames(rounds: int):
    """A block wallpaper (a cheap IDR), then per round a dialog backdrop
    over it, lightening and darkening in turn (a full P frame), and its
    region scrolled by 16 rows with a new row of blocks (a delta with
    remaps and a busy slice)."""
    rng = np.random.default_rng(2040)
    a = _block_wallpaper(rng)
    trace = [(a, None, None, "")]
    for r in range(rounds):
        win = _overlay(a, (24 + 8 * r) * (-1) ** r)  # a new backdrop every round
        trace += [(win, None, None, ""), (_scroll_window(win, rng), None, None, "")]
    return trace


def _time_entropy(coder: str, device_entropy: bool, rounds: int = 3) -> dict:
    """Median FrameStats split and down bytes of the full-P and scroll-delta
    frames of ``_entropy_timing_frames`` (the first round warms up) on a
    flat encoder of this coder and device-entropy setting, and the device
    busy and idle share of two more rounds under torch.profiler."""
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    trace = _entropy_timing_frames(rounds + 2)
    enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", frame_batch=1,
                           pipeline_depth=0, ltr_scenes=False, entropy_coder=coder,
                           device_entropy=device_entropy, bits_min_mbs=64)
    rows = _drive_host(enc, trace[:1 + 2 * rounds])[3:]
    out = {}
    for kind_name in ("full", "delta"):
        sel = [r for r in rows if r[1].upload_kind == kind_name]
        if not sel:
            _fail(f"entropy timing {coder} {device_entropy}: kinds "
                  f"{[r[1].upload_kind for r in rows]}")
        med = {k: statistics.median(getattr(r[1], k) for r in sel) for k in (
            "step_ms", "fetch_ms", "unpack_ms", "cavlc_ms", "pack_ms", "device_ms", "bytes")}
        med["down_bytes"] = statistics.median(r[4] for r in sel)
        med["downlink_mode"] = sorted({r[1].downlink_mode for r in sel})
        med["frames"] = len(sel)
        out[kind_name] = med
    tail = trace[1 + 2 * rounds:]
    out["profile"] = _profile_frames(enc, [], False, len(tail), feed=lambda i: tail[i][0])
    enc.close()
    return out


def _time_entropy_downlink(dev) -> dict:
    """The device-entropy delta downlink alone (CUDA events, the host
    issuing the calls): ``pack_p_sparse_entropy`` with the encoder's
    consts at the top bucket, and each coder at the smallest bucket that
    holds the frame, on the encode outputs of a 1080p window scroll (a busy
    delta) and of a new window (a full-P frame)."""
    import torch
    from selkies_tpu_torch.models.h264 import encoder as enc_mod
    from selkies_tpu_torch.models.h264.device_cabac import pack_p_slice_tokens_active
    from selkies_tpu_torch.models.h264.device_cavlc import (
        bits_buckets, pack_p_slice_bits_active, resolve_entropy)
    from selkies_tpu_torch.models.h264.encoder_core import (
        encode_frame_p_planes, pack_p_sparse_entropy, pack_p_sparse_packed)

    trace = _entropy_timing_frames(1)
    a, win, scrolled = (enc_mod._convert_pad(torch.from_numpy(f).to(dev), pad_h=1088,
                                             pad_w=W, channels=4) for f, *_ in trace)
    m = 68 * 120
    res = {}
    for name, cur, ref in (("scroll_delta", scrolled, win), ("full_p", win, a)):
        out = encode_frame_p_planes(*cur, *ref, 28)
        ns = int((~out["skip"]).sum())
        small = next(b for b in bits_buckets(m) if b >= ns)
        row = {"coded_mbs": ns, "smallest_bucket": small, "top_bucket": m}
        row["sparse_packed_ms"] = _time_cuda(
            lambda: pack_p_sparse_packed(out, enc_mod.NSCAP, enc_mod.CAP_ROWS_DELTA, 75),
            iters=10)
        for coder, fn in (("cavlc", pack_p_slice_bits_active),
                          ("cabac", pack_p_slice_tokens_active)):
            _, _, words, consts = resolve_entropy(m, True, 64, coder)
            row[f"{coder}_downlink_top_ms"] = _time_cuda(
                lambda: pack_p_sparse_entropy(out, enc_mod.NSCAP, enc_mod.CAP_ROWS_DELTA, 75,
                                              *consts), iters=10)
            row[f"{coder}_coder_top_ms"] = _time_cuda(
                lambda: fn(out, words, consts[2]), iters=10)
            row[f"{coder}_coder_smallest_ms"] = _time_cuda(
                lambda: fn(out, words, consts[2], bucket=small), iters=10)
        res[name] = row
    return res


def _time_cuda(fn, iters: int, warmup: int = 3, hold: bool = False) -> float:
    """Milliseconds per call by CUDA events around ``iters`` calls. With
    ``hold`` the stream first runs a ~10 ms spin kernel, so the host queues
    every call before the first starts and the events time the device
    alone, not the host's rate of issuing calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile_frames(enc, frames, idr: bool, n: int, feed=None, expect: str = "") -> dict:
    """Device busy and idle share over n frames (torch.profiler kernel and
    copy intervals, merged), and the kernels that took the most time.
    Every profile window of this script records device activity only, as
    ``_device_activity`` reads: recording the host's ops as well cost
    seconds a window and stretched the wall time the idle share divides.
    ``feed(i)`` picks frame i (default: frame 0 as forced IDRs, or frames 1
    and 2 in turn); ``expect`` is the upload_kind every frame must have.
    "not measured" when the profiler reports no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    feed = feed or (lambda i: frames[0] if idr else frames[1 + i % 2])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = []
        for i in range(n):
            if idr:
                enc.force_keyframe()
            outs += enc.submit(feed(i))
        outs += enc.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if len(outs) != n:
        _fail(f"profiled {n} frames, {len(outs)} came back")
    for i, (_, st, _) in enumerate(outs):
        if expect and st.upload_kind != expect:
            _fail(f"profiled frame {i} is {st.upload_kind}, not {expect}")
    return {"frames": n, **_device_activity(prof, wall_ms)}


def _profile_host_deltas(enc, n: int) -> dict:
    """Device busy and idle share over n typing-delta frames of the
    host-conversion encoder (torch.profiler, as _profile_frames)."""
    a, _, typed, _ = _host_frames(7)
    enc.force_keyframe()
    enc.submit(a)
    rng = np.random.default_rng(8)
    frames = []
    for i in range(n):
        f = a.copy()
        f[500:516, 300 + 16 * i:700 + 16 * i, :3] = rng.integers(0, 255, (16, 400, 3), np.uint8)
        frames.append(f)
    enc.submit(frames[-1])  # warm
    enc.flush()
    return _profile_frames(enc, frames, False, n, feed=lambda i: frames[i],
                           expect="delta")


def _band_trace(w: int = W, h: int = H, light: bool = False, seed: int = 2032):
    """-> [(frame, op)], a full-motion trace: a desktop (IDR), two busy
    scrolls (24 and 40 rows), a window opened over it, the window dragged
    down and right across the band seams (a quarter of the height), a
    static repeat, and a forced IDR on a second drag. ``light``: flat 16x16
    blocks without glyph noise, for the host CABAC coder (Python per MB)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(30, 220, (h // 16 + 1, w // 16 + 1, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))[:h, :w].copy()
    if not light:
        glyphs = rng.integers(0, 2, (h // 4, w // 2, 1), np.uint8) * 180
        base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    s1 = np.roll(base, -24, 0)
    s2 = np.roll(s1, -40, 0)
    wy, wx, wh, ww = h // 8, w // 4, h // 4, w // 3
    if light:
        content = np.kron(rng.integers(30, 250, (wh // 16 + 1, ww // 16 + 1, 4), np.uint8),
                          np.ones((16, 16, 1), np.uint8))[:wh, :ww]
    else:
        content = rng.integers(0, 255, (wh, ww, 4), np.uint8)

    def window(dy, dx):
        f = s2.copy()
        f[wy + dy:wy + dy + wh, wx + dx:wx + dx + ww] = content
        return f
    drag = window(h // 4, w // 16)
    return [(base, None), (s1, None), (s2, None), (window(0, 0), None), (drag, None),
            (drag.copy(), None), (window(h // 4 + 24, w // 16 + 40), "idr")]


def _drive_band(enc, trace):
    """-> ([(sha256, FrameStats)], K1 launches per frame)."""
    from selkies_tpu_torch.models.h264 import me_mc

    out, launches = [], []
    for i, (frame, op) in enumerate(trace):
        if op == "idr":
            enc.force_keyframe()
        before = me_mc.launches
        (au, st, _), = enc.submit(frame)
        launches.append(me_mc.launches - before)
        if not au.startswith(b"\x00\x00\x00\x01"):
            _fail(f"band frame {i}: access unit is not Annex-B")
        out.append((hashlib.sha256(au).hexdigest(), st))
    return out, launches


def _p_frames(rows) -> int:
    return sum(1 for _, st in rows if not st.idr and st.upload_kind != "static")


def _time_band_split(enc, frames, n_idr: int = 1) -> dict:
    """Median FrameStats split per frame kind: ``frames[0]`` as an IDR and
    ``frames[1]`` as a P frame warm up, then every later frame as a P frame
    and ``n_idr`` forced IDRs of ``frames[0]``."""
    prev = enc.link_bytes.snapshot()

    def one(frame, idr):
        nonlocal prev
        if idr:
            enc.force_keyframe()
        (_, st, _), = enc.submit(frame)
        links = enc.link_bytes.snapshot()
        grown = {k: v - prev.get(k, 0) for k, v in links.items()}
        prev = links
        if st.idr != idr or st.upload_kind == "static":
            _fail(f"band timing frame has the wrong kind ({st.idr}, {st.upload_kind})")
        return (st, sum(v for k, v in grown.items() if k.startswith("up_")),
                sum(v for k, v in grown.items() if k.startswith("down_")))

    one(frames[0], True)
    one(frames[1], False)
    rows = {"p": [one(f, False) for f in frames[2:]],
            "idr": [one(frames[0], True) for _ in range(n_idr)]}
    out = {}
    for kind_name, sel in rows.items():
        med = {k: statistics.median(getattr(st, k) for st, *_ in sel) for k in (
            "upload_ms", "step_ms", "fetch_ms", "unpack_ms", "cavlc_ms", "pack_ms",
            "device_ms", "bytes")}
        steps = [st.band_step_ms for st, *_ in sel if st.band_step_ms]
        if steps:
            med["band_step_ms_min"] = statistics.median(min(b) for b in steps)
            med["band_step_ms_max"] = statistics.median(max(b) for b in steps)
        med["up_bytes"] = statistics.median(r[1] for r in sel)
        med["down_bytes"] = statistics.median(r[2] for r in sel)
        med["frames"] = len(sel)
        out[kind_name] = med
    return out


def _scroll_run(w: int, h: int, n: int):
    """The full-motion trace's desktop, then n scrolls of 24 more rows each."""
    base = _band_trace(w, h)[0][0]
    return [base] + [np.roll(base, -24 * (k + 1), 0) for k in range(n)]


SW, SH = 1920, 1088  # the multi-session geometry (MB-aligned, as JAX requires)


def _batch_me_inputs(n: int, h: int, w: int, seed: int, dev):
    """The batched kernel's inputs for n sessions, each with its own seeded
    content, motion and noise, and its own coarse-voted candidate list
    (built as the batched P step builds them)."""
    import torch

    from selkies_tpu_torch.models.h264 import encoder_core as core

    rng = np.random.default_rng(seed)
    planes = [_planes(h, w, seed + i, tuple(int(x) for x in rng.integers(-34, 35, 2)),
                      int(rng.integers(0, 13)), dev) for i in range(n)]
    cur, ref, cu, cv = (torch.stack(t) for t in zip(*planes))
    cands = core._refine_cands(core.coarse_vote_candidates(cur, ref))
    return (cands, cur, *(core.edge_pad(p, core.MV_PAD) for p in (ref, cu, cv)))


def _intra_phase(dev, timing: bool) -> dict:
    """The intra kernel (one call per IDR step) against its plain version at
    the main path's shapes, 1 and 8 sessions of 1088x1920 with seeded QPs
    (0 and 51 among them): every output exactly equal. With ``timing``, the
    kernel by CUDA events over 20 calls queued behind a spin kernel (and as
    the host issues them), the plain version, the byte floor, and the two
    halves of the serial chain alone: row 0 (a 16x1920 plane, 120 MB steps)
    and one MB column (1088x16, 1 + 67 steps)."""
    import torch

    from selkies_tpu_torch.models.h264 import encoder_core as core
    from selkies_tpu_torch.models.h264 import intra

    def inputs(n, h, w, seed):
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 256, (n, h, w), np.uint8)
        u, v = (rng.integers(0, 256, (n, h // 2, w // 2), np.uint8) for _ in range(2))
        qps = rng.integers(0, 52, n).astype(np.int32)
        qps[:2] = [0, 51][:n]
        rows = core._QPRows.gather(torch.from_numpy(qps).to(dev))
        return [torch.from_numpy(a).to(dev) for a in (y, u, v)] + [rows]

    res = {}
    for n in (1, 8):
        y, u, v, rows = inputs(n, 1088, 1920, 70 + n)
        before = intra.launches
        got = intra.encode_intra(y, u, v, rows.rows)
        want = core._encode_intra_plain(y, u, v, rows)
        torch.cuda.synchronize()
        if intra.launches != before + 1:
            _fail(f"intra {n} sessions: {intra.launches - before} launches for one call")
        for key in want:
            if got[key].dtype != want[key].dtype or not torch.equal(got[key], want[key]):
                _fail(f"intra {n} x 1088x1920: {key} differs from the plain version")
        row = {"sessions": n, "shape": [1088, 1920], "exact": True}
        if timing:
            def call():
                return intra.encode_intra(y, u, v, rows.rows)

            row["ms"] = _time_cuda(call, iters=20, hold=True)
            row["host_issued_ms"] = _time_cuda(call, iters=20)
            row["plain_ms"] = _time_cuda(lambda: core._encode_intra_plain(y, u, v, rows),
                                         iters=2, warmup=1)
            nbytes = sum(t.numel() * t.element_size() for t in (y, u, v))
            nbytes += sum(t.numel() * t.element_size() for t in got.values())
            row["bytes"] = nbytes
            row["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row["chain_steps"] = 1088 // 16 - 1 + 1920 // 16
            row["us_per_chain_step"] = row["ms"] * 1e3 / row["chain_steps"]
        res[f"n{n}"] = row
    if timing:
        for name, (h, w) in (("row0_16x1920", (16, 1920)), ("column_1088x16", (1088, 16))):
            y, u, v, rows = inputs(1, h, w, 80)
            ms = _time_cuda(lambda: intra.encode_intra(y, u, v, rows.rows), iters=20, hold=True)
            steps = w // 16 if h == 16 else h // 16
            res[name] = {"ms": ms, "mb_steps": steps, "us_per_step": ms * 1e3 / steps}
    return res


def _colorspace_phase(dev, timing: bool) -> dict:
    """The BGRx->I420 kernel (one launch per call) against its plain
    version at the service's shape, 8 x 1088x1920 of seeded random BGRx,
    and one unbatched frame: every plane exactly equal. With ``timing``,
    the kernel by CUDA events over 50 launches queued behind a spin kernel
    (and as the host issues them), the plain version on the card, and the
    byte bound (every input byte read once, every plane byte written once,
    at 3.35 TB/s)."""
    import torch

    from selkies_tpu_torch.ops import colorspace

    res = {}
    for name, shape in (("n8", (8, 1088, 1920, 4)), ("single", (1088, 1920, 4))):
        rng = np.random.default_rng(90 + len(shape))
        frame = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        before = colorspace.launches
        got = colorspace.bgrx_to_i420(frame)
        want = colorspace.bgrx_to_i420_plain(frame)
        torch.cuda.synchronize()
        if colorspace.launches != before + 1:
            _fail(f"bgrx_to_i420 {name}: {colorspace.launches - before} launches for one call")
        for plane, g, w in zip("yuv", got, want):
            if not torch.equal(g, w):
                _fail(f"bgrx_to_i420 {name}: plane {plane} differs from the plain version")
        row = {"shape": list(shape), "exact": True}
        if timing:
            def call():
                return colorspace.bgrx_to_i420(frame)

            row["ms"] = _time_cuda(call, iters=50, hold=True)
            row["host_issued_ms"] = _time_cuda(call, iters=50)
            row["plain_ms"] = _time_cuda(lambda: colorspace.bgrx_to_i420_plain(frame), iters=5,
                                         warmup=1)
            nbytes = frame.numel() + sum(t.numel() for t in got)
            row["bytes"] = nbytes
            row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row["bound_share"] = row["bound_ms"] / row["ms"]
        res[name] = row
    return res


def _session_base(i: int, w: int, h: int):
    """Session i's desktop: a block wallpaper with glyph rows, its own seed."""
    rng = np.random.default_rng(3000 + i)
    base = np.kron(rng.integers(30, 220, (h // 16, w // 16, 4), np.uint8),
                   np.ones((16, 16, 1), np.uint8))
    glyphs = rng.integers(0, 2, (h // 4, w // 2, 1), np.uint8) * 180
    base[::4, ::2, :3] = np.minimum(base[::4, ::2, :3] + glyphs, 255)
    return base


def _session_frame(base, i: int, t: int):
    """Session i's frame at tick t: even sessions scroll by 8 + 4i rows a
    tick, odd ones type a new 16-row line a tick on a pan of 2 columns."""
    h, w = base.shape[:2]
    if i % 2 == 0:
        return np.roll(base, -(8 + 4 * i) * t, 0)
    f = np.roll(base, 2 * t, 1)
    lw = min(400, w - 64)
    for k in range(1, t + 1):
        r = (48 + 32 * k + 16 * i) % (h - 16)
        f[r:r + 16, 64:64 + lw, :3] = np.random.default_rng(4000 + 10 * i + k).integers(
            0, 255, (16, lw, 3), np.uint8)
    return f


# the multi-session phase's ops before each tick: ("qp", session, qp),
# ("key", session); tick 0 keys every session, ticks 1-2 are P ticks
SESSION_OPS = {3: [("qp", 1, 24), ("qp", 2, 34), ("key", 3)], 4: [("key", 5), ("key", 6)]}
SESSION_TICKS = 6


def _drive_sessions(svc, bases):
    """-> (per tick the sessions' AU sha256s, per tick K1 launches, per
    session its QP per tick, the forced ticks per session)."""
    from selkies_tpu_torch.models.h264 import me_mc

    n = len(bases)
    shas, launches = [], []
    qps = {i: [] for i in range(n)}
    forced = {i: [] for i in range(n)}
    for t in range(SESSION_TICKS):
        for op in SESSION_OPS.get(t, ()):
            if op[1] >= n:
                continue
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
                forced[op[1]].append(t)
        for i in range(n):
            qps[i].append(svc.sessions[i].qp)
        batch = np.stack([_session_frame(b, i, t) for i, b in enumerate(bases)])
        k0 = me_mc.launches
        aus = svc.encode_tick(batch)
        launches.append(me_mc.launches - k0)
        if not all(au.startswith(b"\x00\x00\x00\x01") for au in aus):
            _fail(f"session tick {t}: an access unit is not Annex-B")
        shas.append([hashlib.sha256(au).hexdigest() for au in aus])
    return shas, launches, qps, forced


class _Gate:
    """Calls pass together; ``shut`` waits until none runs and holds new
    ones back until ``open``."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active, self._shut = 0, False

    @contextlib.contextmanager
    def call(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._shut)
            self._active += 1
        try:
            yield
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    def shut(self, timeout_s: float = 60.0) -> None:
        with self._cond:
            self._shut = True
            if not self._cond.wait_for(lambda: self._active == 0, timeout_s):
                self._shut = False
                self._cond.notify_all()
                _fail(f"a gated call ran past {timeout_s} s")

    def open(self) -> None:
        with self._cond:
            self._shut = False
            self._cond.notify_all()


class _Gated:
    """Forwards every attribute of ``inner``; the ``calls`` named (each made
    from a worker thread, never the event loop's) pass ``gate``."""

    def __init__(self, inner, gate: _Gate, calls: tuple):
        self.__dict__.update(inner=inner, gate=gate, calls=calls)

    def __getattr__(self, attr):
        val = getattr(self.inner, attr)
        if attr not in self.calls:
            return val

        def call(*a, **k):
            with self.gate.call():
                return val(*a, **k)
        return call

    def __setattr__(self, attr, value):
        setattr(self.inner, attr, value)


ENCODER_CALLS = ("submit", "encode_frame", "flush", "prewarm")  # what issues device work


async def _live_profile(gate: _Gate, wait) -> tuple:
    """torch.profiler over a live serving loop while ``await wait()`` runs
    -> (profiler, wall ms). The profiler starts and stops while ``gate`` is
    shut, with none of the loop's device-issuing calls running: a stop that
    raced a worker thread's device ops crashed the process with a
    segmentation fault in the profiler's ``__exit__`` (ROADMAP queue 3).
    Device activity only (the CPU's without a card): the idle share reads
    nothing else."""
    import asyncio

    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
            else torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts)
    await asyncio.to_thread(gate.shut)
    try:
        prof.start()
        t0 = time.perf_counter()
    finally:
        gate.open()
    await wait()
    await asyncio.to_thread(gate.shut)
    try:
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
    finally:
        gate.open()
    return prof, wall_ms


def _device_activity(prof, wall_ms: float) -> dict:
    """torch.profiler's device events -> busy ms (kernel and copy intervals,
    merged), idle share, op count, K1's share and the costliest kernels.
    "not measured" when the profiler reports no device activity."""
    import torch

    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in dev:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    k1 = [v for k, v in by_name.items() if "me_mc_kernel" in k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ops": len(dev),
            "me_mc_kernel": {"ms": sum(v[0] for v in k1), "count": sum(v[1] for v in k1)},
            "top": [{"name": k[:80], "ms": v[0], "count": v[1]} for k, v in top]}


def _scrolled(bases, t: int) -> list:
    """The full-motion timing trace at tick t: session i scrolls its
    desktop by 8 + 2i rows a tick (all within the search's reach of 34)."""
    return [np.roll(b, -(8 + 2 * i) * t, 0) for i, b in enumerate(bases)]


def _time_sessions(n: int, p_ticks: int = 6, prof_ticks: int = 3) -> dict:
    """The service at n sessions of 1920x1088 on full motion (_scrolled):
    the IDR tick, the median
    split of p_ticks back-to-back P ticks after two warm-up ticks, frames
    per second over them (n x ticks / s), a mixed tick with one IDR, the
    device ops and idle share per P tick over prof_ticks more
    (torch.profiler) and the peak device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    bases = [_session_base(i, SW, SH) for i in range(n)]

    def batch(t):
        return np.stack(_scrolled(bases, t))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = TorchMultiSessionH264Service(n, SW, SH, qp=28, device="cuda")
    t0 = time.perf_counter()
    svc.encode_tick(batch(0))
    out = {"sessions": n, "idr_tick_ms": (time.perf_counter() - t0) * 1e3,
           "idr_tick": dict(svc.last_timing)}
    for t in (1, 2):
        svc.encode_tick(batch(t))
    p = [batch(t) for t in range(3, 3 + p_ticks)]
    rows = []
    k0 = me_mc.launches
    t0 = time.perf_counter()
    for b in p:
        svc.encode_tick(b)
        rows.append(dict(svc.last_timing))
    wall = time.perf_counter() - t0
    if me_mc.launches - k0 != p_ticks:
        _fail(f"sessions {n}: K1 launched {me_mc.launches - k0} times in {p_ticks} P ticks")
    out["p_tick"] = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    out["p_tick_wall_ms"] = wall * 1e3 / p_ticks
    out["fps"] = n * p_ticks / wall
    del p
    svc.force_keyframe(0)
    t0 = time.perf_counter()
    svc.encode_tick(batch(3 + p_ticks))
    out["mixed_tick_ms"] = (time.perf_counter() - t0) * 1e3
    out["mixed_tick"] = dict(svc.last_timing)
    pb = [batch(t) for t in range(4 + p_ticks, 4 + p_ticks + prof_ticks)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in pb:
            svc.encode_tick(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = _device_activity(prof, wall_ms)
    act["ticks"] = prof_ticks
    if isinstance(act.get("device_ops"), int):
        act["device_ops_per_tick"] = act["device_ops"] / prof_ticks
    out["profile_p"] = act
    out["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
    svc.close()
    return out


def _time_solo_in_turn(n: int, p_ticks: int = 6) -> dict:
    """The frames of _time_sessions(n) through n solo flat encoders
    (host conversion, no tile cache: full P frames, as the service codes
    them), stepped in turn: the IDR tick, and per P tick the wall time of
    the n encodes after two warm-up ticks."""
    import torch

    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder

    bases = [_session_base(i, SW, SH) for i in range(n)]
    encs = [TorchH264Encoder(SW, SH, qp=28, device="cuda", tile_cache=0, frame_batch=1,
                             pipeline_depth=0, ltr_scenes=False) for _ in range(n)]

    def tick(t):
        frames = _scrolled(bases, t)
        t0 = time.perf_counter()
        for e, f in zip(encs, frames):
            e.encode_frame(f)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"sessions": n, "idr_tick_ms": tick(0)}
    tick(1)
    tick(2)
    ms = [tick(t) for t in range(3, 3 + p_ticks)]
    out["p_tick_ms"] = statistics.median(ms)
    out["fps"] = n * 1e3 / statistics.mean(ms)
    for e in encs:
        e.close()
    return out


# -- phase 12: the hybrid VP9/AV1 rows and the registry ---------------------

HYBRID_ROWS = (("tpuvp9enc", "libvpx"), ("tpuav1enc", "libaom"))


def _hybrid_trace():
    """-> [(frame, op, kind)], 13 frames at 1080p: desktop A (the first
    frame), two static repeats, two typed lines, a 1024x528 window over A,
    a 16-row scroll of the window (a new line at its bottom), the window
    dragged 24 rows down and 40 columns right, a single-byte change to one
    channel, a static repeat, a forced keyframe on it and two repeats."""
    a, win, _, scrolled = _host_frames(2040)
    rng = np.random.default_rng(2041)
    t1 = _type(a, rng, 300, 200)
    t2 = _type(t1, rng, 332, 260)
    win = t2.copy()
    win[192:720, 384:1408] = scrolled[192:720, 384:1408]
    scroll = win.copy()
    scroll[192:704, 384:1408] = win[208:720, 384:1408]
    scroll[704:720, 384:1408] = rng.integers(0, 255, (16, 1024, 4), np.uint8)
    drag = t2.copy()
    drag[216:744, 424:1448] = scroll[192:720, 384:1408]
    one_byte = drag.copy()
    one_byte[700, 1000, 1] ^= 1
    return [(a, None, "full"), (a.copy(), None, "static"), (a.copy(), None, "static"),
            (t1, None, "typing"), (t2, None, "typing"), (win, None, "full"),
            (scroll, None, "scroll"), (drag, None, "drag"), (one_byte, None, "one_byte"),
            (one_byte.copy(), None, "static"), (one_byte.copy(), "key", "key"),
            (one_byte.copy(), None, "static"), (one_byte.copy(), None, "static")]


def _drive_hybrid(enc, trace, rounds: int = 1):
    """-> per frame: (sha256, the map handed to set_active_map or None,
    kind, front-end ms, library ms, conversion ms, AU) and the static and
    active-map counts. The front-end ms is the host clock around the row's
    classification; the library ms is FrameStats' encode time less the
    device front-end's share (0 for a frame the row does not encode)."""
    classify, set_map = enc._classify_mbs, enc.set_active_map
    seen: dict = {}

    def timed(frame):
        t0 = time.perf_counter()
        out = classify(frame)
        seen["fe_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def spy(active):
        if active is not None:
            seen["map"] = hashlib.sha256(np.asarray(active, bool).tobytes()).hexdigest()
        return set_map(active)

    enc._classify_mbs, enc.set_active_map = timed, spy
    rows = []
    for r in range(rounds):
        for frame, op, kind in trace:
            if op == "key":
                enc.force_keyframe()
            seen.pop("map", None)
            au = enc.encode_frame(frame)
            st = enc.last_stats
            # the static short-cut converts nothing: its FrameStats has pack_ms 0
            coded = st.pack_ms > 0
            fe_dev = enc.frontend_device_ms if enc.frontend_mode == "device" else 0.0
            lib_ms = (st.device_ms - fe_dev) if coded else 0.0
            rows.append((hashlib.sha256(au).hexdigest(), seen.get("map"),
                         kind if rows else "first", seen["fe_ms"], lib_ms,
                         st.pack_ms, au))
    counts = (enc.static_frames, enc.active_map_frames)
    enc.close()
    return rows, counts


def _hybrid_phase() -> dict:
    """(a) the device front-end on the card against the CPU; (b) the VP9
    and AV1 rows from the registry on the card against the CPU; (c) the
    tpuh264enc row from the registry, prewarmed, against a directly built
    encoder, with K1's launches counted over that run."""
    import torch

    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.models.registry import create_encoder

    trace = _hybrid_trace()
    out: dict = {}
    # (a) the front-end, a reset at the keyframe
    fe_runs = {}
    for dev in ("cuda", "cpu"):
        fe = DeviceDeltaFrontend(W, H, device=dev)
        steps = []
        for frame, op, _ in trace:
            if op == "key":
                fe.reset()
            votes = fe.votes
            steps.append((*fe.step(frame), fe.votes - votes))
        fe_runs[dev] = steps
    for i, ((gd, gh, gv), (cd, ch, cv), (_, _, kind)) in enumerate(
            zip(fe_runs["cuda"], fe_runs["cpu"], trace)):
        if cd is None:
            if gd is not None or gh is not None:
                _fail(f"front-end frame {i}: the card gave a map where the cpu gave none")
            continue
        if gd.shape != (68, 120) or not np.array_equal(gd, cd) or not np.array_equal(gh, ch):
            _fail(f"front-end frame {i} ({kind}): the card's map or hints differ from the cpu's")
        if gv != cv or gv != int(cd.any()):
            _fail(f"front-end frame {i} ({kind}): {gv} votes on the card, {cv} on the cpu")
        if kind == "static" and (cd.any() or gv):
            _fail(f"front-end frame {i}: a static frame is dirty or voted")
        if kind == "one_byte" and int(cd.sum()) != 1:
            _fail(f"front-end: the one-byte change marks {int(cd.sum())} MBs")
    out["frontend"] = {
        "frames": [k for *_, k in trace],
        "dirty_mbs": [None if d is None else int(d.sum()) for d, _, _ in fe_runs["cuda"]],
        "hints": [None if h is None else h.tolist() for _, h, _ in fe_runs["cuda"]],
        "votes": sum(v for *_, v in fe_runs["cuda"])}
    print("hybrid front-end 1920x1080: the card's dirty maps and hints equal the cpu run's "
          f"on {len(trace)} frames; dirty MBs {out['frontend']['dirty_mbs']}; votes "
          f"{out['frontend']['votes']} (none on a static frame)")

    # (b) the rows, frontend="device", the card against the cpu
    avail = {"libvpx": libvpx_enc.libvpx_available(), "libaom": libaom_enc.libaom_available()}
    for row, lib in HYBRID_ROWS:
        if not avail[lib]:
            skip = {"row": row, "skipped": f"{lib} not loadable"}
            print(json.dumps(skip))
            out[row] = skip
            continue
        auto = create_encoder(row, width=W, height=H)
        if auto.frontend_mode != "device" or auto.device.type != "cuda":
            _fail(f"{row}: frontend 'auto' resolved to {auto.frontend_mode} on "
                  f"{auto.device}")
        auto.close()
        # libvpx does not repeat its own bytes with VP9 row-mt on (the
        # port's CPU tests): byte equality is held with it off, as
        # SELKIES_VP9_ROW_MT=0 sets; with it on, the maps and static AUs
        vp9 = row == "tpuvp9enc"
        modes = ("probed", "off") if vp9 else ("probed",)
        probed = libvpx_enc._row_mt_available() if vp9 else None
        runs = {}
        for mode in modes:
            if vp9:
                libvpx_enc._row_mt_state = probed if mode == "probed" else False
            for dev in ("cuda", "cpu"):
                enc = create_encoder(row, width=W, height=H, frontend="device", device=dev)
                runs[mode, dev] = _drive_hybrid(enc, trace)
        if vp9:
            libvpx_enc._row_mt_state = probed
        exact = "off" if vp9 else "probed"
        (g, gc), (c, cc) = runs[exact, "cuda"], runs[exact, "cpu"]
        if [r[0] for r in g] != [r[0] for r in c] or gc != cc:
            bad = [i for i, (x, y) in enumerate(zip(g, c)) if x[0] != y[0]]
            _fail(f"{row}: the card's AUs differ from the cpu run's at frames {bad}")
        for mode in modes:
            (g, gc), (c, cc) = runs[mode, "cuda"], runs[mode, "cpu"]
            if [r[1] for r in g] != [r[1] for r in c] or gc != cc:
                _fail(f"{row} ({mode}): the active maps or counts differ from the cpu run's")
            statics = [r[6] for r in g if r[2] == "static"]
            size = 1 if vp9 else 5
            # AV1: the first repeat after each keyframe is an all-skip encode
            reshown = [s for s in statics if len(s) == size]
            if len(reshown) != len(statics) - (0 if vp9 else 2):
                _fail(f"{row} ({mode}): static AU sizes {[len(s) for s in statics]}")
            if vp9:
                dec = libvpx_enc.LibVpxDecoder()
                shown = [len(dec.decode(r[6])) for r in g]
                dec.close()
                if shown != [1] * len(g):
                    _fail(f"{row} ({mode}): decoded pictures per AU {shown}")
        g, counts = runs[exact, "cuda"]
        out[row] = {"exact": exact, "row_mt_probed": probed,
                    "sha256": [r[0] for r in g], "bytes": [len(r[6]) for r in g],
                    "static_frames": counts[0], "active_map_frames": counts[1]}
        print(f"{row} 1920x1080, frontend device: the card's AUs sha256-equal the cpu run's "
              f"({'row-mt off' if exact == 'off' else 'as configured'}); active maps and "
              f"static AUs equal with row-mt {f'as probed ({probed})' if vp9 else 'as configured'}; "
              f"AU bytes {out[row]['bytes']}; static {counts[0]}, active-map {counts[1]}; "
              f"'auto' resolves to the device front-end")

    # (c) tpuh264enc from the registry, prewarmed, against a direct build
    typing = _typing_run(12, 300)
    reg = create_encoder("tpuh264enc", width=W, height=H, device="cuda")
    reg.prewarm()
    if reg.frame_index != 0 or not reg._force_idr:
        _fail(f"prewarm left frame_index {reg.frame_index}, force_idr {reg._force_idr}")
    trace_h = [(f, None) for f in typing]
    me_mc.launches = 0
    got, _ = _drive_registry(reg, trace_h)
    torch.cuda.synchronize()
    launches = me_mc.launches
    reg.close()
    direct = TorchH264Encoder(W, H, qp=28, frame_batch=4, pipeline_depth=2, scene_qp_boost=6,
                              device="cuda")
    want, _ = _drive_registry(direct, trace_h)
    direct.close()
    if [s for s, _ in got] != [s for s, _ in want]:
        _fail("tpuh264enc from the registry: AUs differ from the direct encoder's")
    first = got[0][1]
    if not first.idr or first.frame_index != 0:
        _fail(f"after prewarm the first frame is idr={first.idr}, index {first.frame_index}")
    p_frames = sum(1 for _, st in got if not st.idr and st.upload_kind != "static")
    if launches != p_frames:
        _fail(f"tpuh264enc registry row: me_mc launched {launches} times for {p_frames} P frames")
    out["tpuh264enc"] = {"frames": len(got), "p_frames": p_frames, "me_mc_launches": launches,
                         "kinds": [st.upload_kind for _, st in got]}
    print(f"tpuh264enc from the registry at 1920x1080 (prewarmed): {len(got)} typing-run AUs "
          f"sha256-equal a TorchH264Encoder(frame_batch=4, pipeline_depth=2, "
          f"scene_qp_boost=6); the first an IDR at frame_index 0; me_mc launched {launches} "
          f"times for {p_frames} P frames")
    return out


def _time_hybrid(card: str, power_limit: str) -> dict:
    """The front-end step on the card per frame kind, its upload, its
    device ops and idle share (torch.profiler), FramePrep.dirty_tiles on
    the same frames, and the VP9/AV1 rows' per-frame split with each
    front-end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.models import libaom_enc, libvpx_enc
    from selkies_tpu_torch.models.frameprep import FramePrep
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.models.registry import create_encoder

    trace = _hybrid_trace()
    rng = np.random.default_rng(2042)
    a, t1, win, scroll = trace[0][0], trace[3][0], trace[5][0], trace[6][0]
    noise = [rng.integers(0, 255, (H, W, 4), np.uint8) for _ in range(2)]
    # each kind alternates two frames, so that every step is that kind
    pairs = {"static": (a, a), "typing": (a, t1), "scroll": (win, scroll),
             "full": (noise[0], noise[1])}
    n, warm = 20, 4
    out: dict = {"card": card, "power_limit": power_limit, "steps": n}
    fe = DeviceDeltaFrontend(W, H, device="cuda")
    prep = FramePrep(W, H, 1920, 1088, nslots=2)
    for kind, (f0, f1) in pairs.items():
        feed = [f1 if i % 2 == 0 else f0 for i in range(warm + n)]
        fe.reset()
        fe.step(f0)
        step_ms, dirty = [], []
        for f in feed:
            d, _ = fe.step(f)
            step_ms.append(fe.last_device_ms)
            dirty.append(int(d.sum()))
        if (kind == "static") == any(dirty):
            _fail(f"front-end timing: {kind} frames gave dirty MB counts {sorted(set(dirty))}")
        prep.reset()
        prep.dirty_tiles(f0, 128)
        host_ms = []
        for f in feed:
            t0 = time.perf_counter()
            prep.dirty_tiles(f, 128)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in feed[:8]:
                fe.step(f)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        act = _device_activity(prof, wall_ms)
        if isinstance(act.get("device_ops"), int):
            act["device_ops_per_step"] = act["device_ops"] / 8
        out[kind] = {"step_ms": statistics.median(step_ms[warm:]),
                     "dirty_mbs": statistics.median(dirty[warm:]),
                     "frameprep_dirty_tiles_ms": statistics.median(host_ms[warm:]),
                     "profile_8_steps": act}
    # the upload alone: host staging copy + the pinned copy, host clock to
    # its completion, and the copy by CUDA events
    h2d_host, h2d_dev = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(warm + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fe._upload(noise[i % 2])
        end.record()
        end.synchronize()
        h2d_host.append((time.perf_counter() - t0) * 1e3)
        h2d_dev.append(start.elapsed_time(end))
    out["h2d"] = {"bytes": H * W * 4, "host_ms": statistics.median(h2d_host[warm:]),
                  "events_ms": statistics.median(h2d_dev[warm:])}
    fe.reset()
    # the rows' per-frame split, each front-end, 3 rounds (the first warms up)
    avail = {"libvpx": libvpx_enc.libvpx_available(), "libaom": libaom_enc.libaom_available()}
    for row, lib in HYBRID_ROWS:
        if not avail[lib]:
            out[row] = {"skipped": f"{lib} not loadable"}
            continue
        for mode in ("device", "host"):
            enc = create_encoder(row, width=W, height=H, frontend=mode, device="cuda")
            rows, _ = _drive_hybrid(enc, trace, rounds=3)
            rows = rows[len(trace):]
            split = {}
            for kind in dict.fromkeys(r[2] for r in rows):
                sel = [r for r in rows if r[2] == kind]
                split[kind] = {"frames": len(sel),
                               "frontend_ms": statistics.median(r[3] for r in sel),
                               "library_ms": statistics.median(r[4] for r in sel),
                               "convert_ms": statistics.median(r[5] for r in sel),
                               "au_bytes": statistics.median(len(r[6]) for r in sel)}
            out[f"{row}_{mode}"] = split
    return out



# -- phase 13: the health and observability plane ----------------------------

def _set_hooks(on: bool) -> None:
    """The port's tracer and telemetry bus, reset, then on or off."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.monitoring.tracing import tracer

    for plane in (tracer, telemetry):
        plane.reset()
        if on:
            plane.enable()
        else:
            plane.disable()


def _span_counts() -> dict:
    from selkies_tpu_torch.monitoring.tracing import tracer

    return {name: a["count"] for name, a in tracer.summary().items()}


def _span_medians() -> dict:
    """Median ms per span name over the tracer's ring."""
    from selkies_tpu_torch.monitoring.tracing import tracer

    by: dict = {}
    for name, _, dur, _ in list(tracer._ring):
        by.setdefault(name, []).append(dur * 1e3)
    return {k: statistics.median(v) for k, v in sorted(by.items())}


def _hook_site_us(n: int = 200000) -> dict:
    """Host microseconds of one hook site, off and on: a tracer span, a
    telemetry count, a stage_ms and the injector read (no spec set), each
    timed over ``n`` calls on this host's clock."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.monitoring.tracing import tracer
    from selkies_tpu_torch.resilience.faultinject import get_injector, reset_faults

    def per_call(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def span():
        with tracer.span("step"):
            pass

    reset_faults()
    out = {}
    for on in (False, True):
        _set_hooks(on)
        key = "on" if on else "off"
        out[f"span_{key}"] = per_call(span)
        out[f"count_{key}"] = per_call(
            lambda: telemetry.count("selkies_tile_cache_frames_total", kind="delta"))
        out[f"stage_ms_{key}"] = per_call(lambda: telemetry.stage_ms("step", 1.0))
    _set_hooks(False)
    out["injector_unset"] = per_call(get_injector)
    return out


def _run_registry_row(trace, dev: str, hooks: bool, spec: str | None = None) -> dict:
    """The registry's tpuh264enc row over ``trace`` with the hooks on or
    off and an optional SELKIES_FAULTS spec: the AUs (sha256 with their
    meta, in completion order), the submits that raised, K1's launches,
    the span counts and the tile-cache counters."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.models.registry import create_encoder
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.resilience import faultinject

    _set_hooks(hooks)
    faultinject.reset_faults()
    if spec:
        faultinject.configure_faults(spec)
    enc = create_encoder("tpuh264enc", width=W, height=H, device=dev)
    rows, raised = [], []
    me_mc.launches = 0
    try:
        for i, frame in enumerate(trace):
            try:
                rows += enc.submit(frame, meta=i)
            except faultinject.InjectedFault:
                raised.append(i)
        rows += enc.flush()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = me_mc.launches
    finally:
        enc.close()
        faultinject.reset_faults()
    counters = {k: v for k, v in telemetry.rollup()["counters"].items()
                if k.startswith("selkies_tile_cache")}
    return {"aus": [(hashlib.sha256(au).hexdigest(), m) for au, _, m in rows],
            "p_frames": sum(1 for _, st, _ in rows if not st.idr and st.upload_kind != "static"),
            "raised": raised, "me_mc_launches": launches, "spans": _span_counts(),
            "counters": counters}


def _observability_phase(band_shas: list) -> dict:
    """(a) the hooks change no byte; (b) the frontend fault site; (c)
    device chaos on the session service and the banded encoder, and a
    readmission through the real probe; (d) the device monitor. Only
    injected faults: a real CUDA error would poison the context for every
    later phase."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor
    from selkies_tpu_torch.monitoring.tracing import tracer
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
    from selkies_tpu_torch.resilience import devhealth, faultinject

    out: dict = {}
    typing = _typing_run(12, 300)  # phase 12's typing trace
    # (a) the registry row, hooks off then on, and the CPU run with them on
    t0 = time.perf_counter()
    off = _run_registry_row(typing, "cuda", hooks=False)
    on = _run_registry_row(typing, "cuda", hooks=True)
    trace_json = tracer.chrome_trace()
    cpu = _run_registry_row(typing, "cpu", hooks=True)
    _set_hooks(False)
    if not off["aus"] == on["aus"] == cpu["aus"] or len(on["aus"]) != len(typing):
        _fail("phase 13 (a): the registry row's AUs differ between hooks off, hooks on and "
              "the cpu run")
    if [m for _, m in on["aus"]] != list(range(len(typing))):
        _fail(f"phase 13 (a): frames came out as {[m for _, m in on['aus']]}")
    if off["spans"] or off["counters"]:
        _fail(f"phase 13 (a): hooks off recorded {off['spans']} {off['counters']}")
    if on["spans"].get("classify") != len(typing):
        _fail(f"phase 13 (a): {on['spans'].get('classify')} classify spans for "
              f"{len(typing)} submits")
    names = ("step", "fetch", "unpack", "pack")
    if any(on["spans"].get(k) != cpu["spans"].get(k) for k in names) or not on["spans"].get(
            "step"):
        _fail(f"phase 13 (a): spans on the card {on['spans']}, on the cpu {cpu['spans']}")
    if on["counters"] != cpu["counters"] or not on["counters"]:
        _fail(f"phase 13 (a): tile-cache counters {on['counters']} != cpu {cpu['counters']}")
    for run_name, run in (("off", off), ("on", on)):
        if run["me_mc_launches"] != run["p_frames"]:
            _fail(f"phase 13 (a), hooks {run_name}: me_mc launched {run['me_mc_launches']} "
                  f"times for {run['p_frames']} P frames")
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase13_trace.json").write_text(trace_json)
    out["a"] = {"frames": len(typing), "spans": on["spans"], "counters": on["counters"],
                "me_mc_launches": on["me_mc_launches"], "p_frames": on["p_frames"],
                "trace_events": len(json.loads(trace_json)["traceEvents"]),
                "seconds": time.perf_counter() - t0}
    print(f"phase 13 (a) tpuh264enc 1920x1080, {len(typing)} typing frames: AUs sha256-equal "
          f"with hooks off, hooks on and the cpu run; spans {on['spans']} (step/fetch/unpack/"
          f"pack as the cpu run's); tile-cache counters {json.dumps(on['counters'])} as the cpu "
          f"run's; me_mc launched {on['me_mc_launches']} times for {on['p_frames']} P frames "
          f"with the hooks on; chrome trace in chiprun_out/phase13_trace.json")

    # (b) the frontend fault site on the registry row
    t0 = time.perf_counter()
    spec = "frontend@4,9:raise"
    g = _run_registry_row(typing, "cuda", hooks=False, spec=spec)
    c = _run_registry_row(typing, "cpu", hooks=False, spec=spec)
    if g["raised"] != [3, 8] or c["raised"] != [3, 8]:
        _fail(f"phase 13 (b): submits {g['raised']} raised on the card, {c['raised']} on the cpu")
    want_meta = [i for i in range(len(typing)) if i not in (3, 8)]
    if [m for _, m in g["aus"]] != want_meta or g["aus"] != c["aus"]:
        _fail("phase 13 (b): the frames after the faults differ or come out of order")
    out["b"] = {"spec": spec, "raised": g["raised"], "frames_out": len(g["aus"]),
                "me_mc_launches": g["me_mc_launches"], "seconds": time.perf_counter() - t0}
    print(f"phase 13 (b) {spec} on the registry row: submits {g['raised']} raised; the other "
          f"{len(g['aus'])} frames came out in order, sha256-equal the cpu run under the same "
          f"spec")

    # (c) device chaos: the session service, the banded encoder, readmission
    t0 = time.perf_counter()
    spec = "device:0@3:raise"
    bases = [_session_base(i, SW, SH) for i in range(8)]
    ses: dict = {}
    for dev_name in ("cuda", "cpu"):
        devhealth.set_device_pool(devhealth.DevicePool(
            None if dev_name == "cuda" else [torch.device("cpu")], fail_threshold=1))
        faultinject.configure_faults(spec)
        svc = TorchMultiSessionH264Service(8, SW, SH, qp=28, device=dev_name)
        ticks = []
        for t in range(5):
            batch = np.stack([_session_frame(b, i, t) for i, b in enumerate(bases)])
            try:
                ticks.append([hashlib.sha256(au).hexdigest() for au in svc.encode_tick(batch)])
            except devhealth.DeviceFault as e:
                ticks.append(("fault", e.chip, svc._inflight,
                              devhealth.note_tick_failure(e, svc.devices)))
        svc.close()
        ses[dev_name] = ticks
    faultinject.reset_faults()
    if ses["cuda"][2] != ("fault", "0", 0, "0"):
        _fail(f"phase 13 (c): tick 3 of the service gave {ses['cuda'][2]}")
    if ses["cuda"] != ses["cpu"]:
        _fail("phase 13 (c): the service's AUs under device:0@3:raise differ from the cpu run's")
    clock = [0.0]
    pool = devhealth.set_device_pool(devhealth.DevicePool(
        fail_threshold=3, probation_s=5.0, readmit_after=3, clock=lambda: clock[0]))
    faultinject.configure_faults("device:0@every:1:flap")
    btrace = _band_trace()
    benc = TorchBandedH264Encoder(W, H, qp=28, bands=4)
    if (benc.device.type, benc.bands, [devhealth.chip_key(d) for d in benc.devices]) != (
            "cuda", 4, ["0"]):
        _fail(f"phase 13 (c): the banded carve through the pool gave {benc.device}, "
              f"{benc.bands} bands, devices {benc.devices}")
    me_mc.launches = 0
    brows, bquar, b_p = [], [], 0
    for frame, op in btrace:
        if op == "idr":
            benc.force_keyframe()
        (au, st, _), = benc.submit(frame)
        brows.append(hashlib.sha256(au).hexdigest())
        bquar.append(pool.quarantined_keys())
        b_p += not st.idr and st.upload_kind != "static"
    torch.cuda.synchronize()
    b_launches = me_mc.launches
    benc.close()
    faultinject.reset_faults()
    if brows != band_shas:
        _fail("phase 13 (c): the banded encoder's AUs under device:0@every:1:flap differ from "
              "phase 8's bands=4 run")
    if bquar[:2] != [[], []] or any(q != ["0"] for q in bquar[2:]):
        _fail(f"phase 13 (c): quarantined chips after each frame {bquar}")
    if pool.stats()["quarantined"]["0"]["failures"] != len(btrace) or b_launches != 4 * b_p:
        _fail(f"phase 13 (c): pool {pool.stats()}, me_mc {b_launches} for {b_p} P frames")
    # readmission: probation over, the real probe on the card, readmit_after probes
    clock[0] += 5.5
    probes = [pool.tick() for _ in range(3)]
    if probes != [[], [], ["0"]] or pool.quarantined_keys():
        _fail(f"phase 13 (c): probes after probation gave {probes}, pool {pool.stats()}")
    dev0 = torch.device("cuda", 0)
    probe_ms = []
    for _ in range(21):
        tp = time.perf_counter()
        if not devhealth._default_probe(dev0):
            _fail("phase 13 (c): the card's probe failed")
        probe_ms.append((time.perf_counter() - tp) * 1e3)
    devhealth.reset_device_pool()
    out["c"] = {"service_ticks": [x if isinstance(x, tuple) else "ok" for x in ses["cuda"]],
                "banded_frames": len(brows), "banded_me_mc_launches": b_launches,
                "banded_quarantined_after": bquar,
                "probes": probes, "probe_ms_median": statistics.median(probe_ms[1:]),
                "seconds": time.perf_counter() - t0}
    print(f"phase 13 (c) device chaos: service 8 x {SW}x{SH} with {spec}: tick 3 raised "
          f"DeviceFault('0') with no tick in flight, note_tick_failure -> '0' (threshold 1), "
          f"the other ticks sha256-equal the cpu run; bands=4 1920x1080 carved through the pool "
          f"onto cuda:0 with device:0@every:1:flap: quarantined at frame 3 (threshold 3), "
          f"{len(brows)} AUs equal phase 8's; after probation 3 probes readmitted the card "
          f"({probes}); probe {out['c']['probe_ms_median']:.4f} ms (median of 20)")

    # (d) the device monitor
    mon = DeviceMonitor(device="cuda")
    total_mb, used_mb = mon._memory_mb()
    card_mb = torch.cuda.get_device_properties(0).total_memory / 1e6
    if abs(total_mb - card_mb) > 0.01 * card_mb or not 0 < used_mb < total_mb:
        _fail(f"phase 13 (d): the monitor read {total_mb} MB total, {used_mb} used; the card "
              f"has {card_mb} MB")
    load = mon._load()
    if not 0.0 <= load <= 1.0:
        _fail(f"phase 13 (d): load {load}")
    out["d"] = {"total_mb": total_mb, "used_mb": used_mb, "card_mb": card_mb, "load": load}
    print(f"phase 13 (d) DeviceMonitor: total {total_mb:.1f} MB (the card's "
          f"{card_mb:.1f} MB), used {used_mb:.1f} MB, load {load:.4f}")
    return out


# -- phase 14: the fleet's banded service, lifecycle and occupancy scheduler --

FLEET_N, FLEET_TICKS = 4, 8
# tick -> ops before it: ("qp", session, qp) / ("key", session); session 3
# repeats its tick-3 frame at tick 4 (a static frame)
FLEET_OPS = {3: [("qp", 1, 24)], 5: [("key", 2)]}
FLEET_STATIC = {(3, 4)}
# the mixed tenancy's ops: a banded session's keyframe, then a batch one's
MIXED_OPS = {3: [("key", 4)], 4: [("key", 1)]}
MIXED_TICKS = 6
FLEET_SMALL = (640, 384)  # 24 MB rows: 2 bands of 12 (368's 23 rows clamp to 1 band)


def _fleet_bases(n: int, w: int, h: int) -> list:
    """Phase 9's desktops (session i's own seed), cut to h rows."""
    return [_session_base(i, w, (h + 15) // 16 * 16)[:h] for i in range(n)]


def _fleet_frame(bases, i: int, t: int):
    """Session i's frame at tick t: phase 9's scroll (even sessions) or
    typing (odd), with FLEET_STATIC's repeats."""
    if (i, t) in FLEET_STATIC:
        t -= 1
    return _session_frame(bases[i], i, t)


def _fleet_batch(bases, t: int):
    return np.stack([_fleet_frame(bases, i, t) for i in range(len(bases))])


def _drive_fleet(svc, tick, bases, ticks=range(FLEET_TICKS), ops=FLEET_OPS, hook=None):
    """-> per tick (the sessions' AU sha256s, or the name of the exception
    the tick raised, last_idrs, K1 launches, the tick's host ms).
    ``hook(t)`` runs before tick t's frames go in, after its ops."""
    from selkies_tpu_torch.models.h264 import me_mc

    out = []
    for t in ticks:
        for op in ops.get(t, ()):
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
        if hook is not None:
            hook(t)
        batch = _fleet_batch(bases, t)
        k0 = me_mc.launches
        t0 = time.perf_counter()
        try:
            aus = tick(batch)
        except Exception as e:  # noqa: BLE001 - the phase checks which tick raised what
            row = type(e).__name__
        else:
            if not all(au == b"" or au.startswith(b"\x00\x00\x00\x01") for au in aus):
                _fail(f"fleet tick {t}: an access unit is not Annex-B")
            row = [hashlib.sha256(au).hexdigest() for au in aus]
        out.append((row, list(svc.last_idrs), me_mc.launches - k0,
                    (time.perf_counter() - t0) * 1e3))
    return out


def _fleet_solo(bases, i: int, ticks, w: int, h: int, key_at=(), dev: str = "cuda") -> list:
    """Session i's AU sha256s from a solo TorchBandedH264Encoder(bands=2)
    fed the given ticks' frames, with the trace's QP and keyframe ops for
    session i and keyframes forced at ``key_at``."""
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    enc = TorchBandedH264Encoder(w, h, qp=28, bands=2, device=dev)
    out = []
    for t in ticks:
        for op in FLEET_OPS.get(t, ()):
            if op[1] == i:
                if op[0] == "qp":
                    enc.set_qp(op[2])
                else:
                    enc.force_keyframe()
        if t in key_at:
            enc.force_keyframe()
        out.append(hashlib.sha256(enc.encode_frame(_fleet_frame(bases, i, t))).hexdigest())
    enc.close()
    return out


def _fleet_launches_ok(run, bands: int, banded: range, batch: range = range(0)) -> list:
    """Expected K1 launches per tick: ``bands`` per banded session that
    coded a P frame (not an IDR, not static, not parked), plus one for the
    batch unit when it has a P session."""
    want = []
    for t, (row, idrs, *_) in enumerate(run):
        if isinstance(row, str):
            want.append(None)
            continue
        empty = hashlib.sha256(b"").hexdigest()
        p = sum(1 for i in banded if not idrs[i] and (i, t) not in FLEET_STATIC
                and row[i] != empty)
        want.append(bands * p + (1 if any(not idrs[i] for i in batch) else 0))
    return want


def _occupancy_tick(svc):
    """The fleet's choice: the scheduler when SELKIES_OCCUPANCY is on and
    the service has a schedulable shape, else the serial tick."""
    from selkies_tpu_torch.parallel.occupancy import OccupancyScheduler, occupancy_enabled

    sched = OccupancyScheduler.for_service(svc) if occupancy_enabled() else None
    return sched, (sched.encode_tick if sched is not None else svc.encode_tick)


def _fleet_phase() -> dict:
    """(a) the banded fleet service, serial and scheduled, against solo
    encoders and the CPU; (b) checkpoint + re-carve, parking; (c) mixed
    tenancy; (d) sched drop and raise; (e) the placer and a drain."""
    import asyncio
    import os

    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.parallel.lifecycle import (
        DrainController,
        SessionPlacer,
        checkpoint_session,
    )
    from selkies_tpu_torch.parallel.occupancy import MixedTenancyService, OccupancyScheduler
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )
    from selkies_tpu_torch.resilience import devhealth, faultinject

    out: dict = {}
    _set_hooks(False)
    faultinject.reset_faults()
    devhealth.set_device_pool(devhealth.DevicePool())
    card = torch.device("cuda", 0)
    empty = hashlib.sha256(b"").hexdigest()
    env0 = os.environ.get("SELKIES_OCCUPANCY")
    bases = _fleet_bases(FLEET_N, W, H)

    # (a) scheduled at W x H against solo card encoders; the small trace
    # scheduled and serial on the card against the serial CPU run (the
    # serial tick at W x H, 26.5-43 s of IDR ticks, left out for the run's
    # time budget)
    t0 = time.perf_counter()
    os.environ["SELKIES_OCCUPANCY"] = "1"
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
    carve = (svc.shared_carve, svc.bands, [str(e.device) for e in svc.encoders])
    sched, tick = _occupancy_tick(svc)
    if sched is None:
        _fail("phase 14 (a): SELKIES_OCCUPANCY=1 gave no scheduler")
    me_mc.launches = 0
    runs = {"occupancy": _drive_fleet(svc, tick, bases)}
    totals = {"occupancy": me_mc.launches}
    out["a_stats"] = sched.stats()
    sched.close()
    svc.close()
    if carve != (True, 2, ["cuda:0"] * FLEET_N):
        _fail(f"phase 14 (a): the service's carve through the pool is {carve}")
    idrs = [r[1] for r in runs["occupancy"]]
    want_idrs = [[t == 0 or (t == 5 and i == 2) for i in range(FLEET_N)]
                 for t in range(FLEET_TICKS)]
    if idrs != want_idrs:
        _fail(f"phase 14 (a): IDR flags {idrs}")
    got = [r[2] for r in runs["occupancy"]]
    if got != _fleet_launches_ok(runs["occupancy"], 2, range(FLEET_N)):
        _fail(f"phase 14 (a): me_mc launches per tick {got}")
    t_solo = time.perf_counter()
    for i in range(FLEET_N):
        solo = _fleet_solo(bases, i, range(FLEET_TICKS), W, H)
        if solo != [runs["occupancy"][t][0][i] for t in range(FLEET_TICKS)]:
            _fail(f"phase 14 (a): session {i} differs from its solo bands=2 card encoder")
    solo_s = time.perf_counter() - t_solo
    sw, sh = FLEET_SMALL
    small_bases = _fleet_bases(FLEET_N, sw, sh)
    small = {}
    for name, dev_name, env in (("cuda", "cuda", "1"), ("cuda_serial", "cuda", "0"),
                                ("cpu", "cpu", "0")):
        os.environ["SELKIES_OCCUPANCY"] = env
        ssvc = TorchBandedFleetService(FLEET_N, sw, sh, qp=28, bands=2, devices=(
            None if dev_name == "cuda" else [torch.device("cpu")]))
        sched, tick = _occupancy_tick(ssvc)
        if (sched is None) != (env == "0"):
            _fail(f"phase 14 (a): SELKIES_OCCUPANCY={env} gave scheduler {sched}")
        me_mc.launches = 0
        tc = time.perf_counter()
        run = _drive_fleet(ssvc, tick, small_bases)
        small[name] = (run, me_mc.launches, time.perf_counter() - tc, ssvc.bands)
        if sched is not None:
            sched.close()
        ssvc.close()
    for name in ("cuda", "cuda_serial"):
        if [r[:2] for r in small[name][0]] != [r[:2] for r in small["cpu"][0]]:
            _fail(f"phase 14 (a): {FLEET_N} x {sw}x{sh} {name} on the card differs from the "
                  "cpu run")
        want_small = _fleet_launches_ok(small[name][0], 2, range(FLEET_N))
        if [r[2] for r in small[name][0]] != want_small or small[name][3] != 2:
            _fail(f"phase 14 (a) {sw}x{sh} {name}: launches {[r[2] for r in small[name][0]]}, "
                  f"want {want_small}, bands {small[name][3]}")
    runs["serial_small"] = small["cuda_serial"][0]
    totals["serial_small"] = small["cuda_serial"][1]
    out["a"] = {
        "sha256": [r[0] for r in runs["occupancy"]], "idrs": idrs,
        "launches_per_tick": {k: [r[2] for r in v] for k, v in runs.items()},
        "tick_ms": {k: [r[3] for r in v] for k, v in runs.items()},
        "me_mc_launches": totals, "solo_s": solo_s,
        "small": {"geometry": f"{sw}x{sh}", "sha256": [r[0] for r in small["cuda"][0]],
                  "me_mc_launches": small["cuda"][1], "cuda_s": small["cuda"][2],
                  "serial_cuda_s": small["cuda_serial"][2], "cpu_s": small["cpu"][2]},
        "seconds": time.perf_counter() - t0}
    print(f"phase 14 (a) TorchBandedFleetService({FLEET_N}, {W}, {H}, bands=2): the shared "
          f"carve on cuda:0 through the pool; {FLEET_TICKS} ticks (IDRs {idrs[0].count(True)} "
          f"+ 1 forced, 1 static, set_qp) through OccupancyScheduler: AUs sha256-equal 4 solo "
          f"bands=2 card encoders; me_mc launches per tick "
          f"{out['a']['launches_per_tick']['occupancy']} (2 per non-static banded P); "
          f"{FLEET_N} x {sw}x{sh} scheduled and serial on the card = the cpu run (launches "
          f"{small['cuda'][1]}, {small['cuda_serial'][1]}); overlap "
          f"{out['a_stats']['overlap_ratio']}; {out['a']['seconds']:.1f} s")

    # (b) checkpoint + re-carve session 0 after tick 3; park session 1 at
    # ticks 4-5, un-park it at tick 6
    t0 = time.perf_counter()
    os.environ["SELKIES_OCCUPANCY"] = "1"
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
    sched, tick = _occupancy_tick(svc)
    rec: dict = {}

    def hook(t):
        if t == 4:
            tr = time.perf_counter()
            svc.recarve(0, [card])
            rec["recarve_ms"] = (time.perf_counter() - tr) * 1e3
            svc.recarve(1, [])
        elif t == 6:
            svc.recarve(1, [card])

    me_mc.launches = 0
    brun = _drive_fleet(svc, tick, bases, hook=hook)
    rec["me_mc_launches"] = me_mc.launches
    sched.close()
    svc.close()
    s0 = [r[0][0] for r in brun]
    if s0 != _fleet_solo(bases, 0, range(FLEET_TICKS), W, H, key_at={4}):
        _fail("phase 14 (b): the re-carved session differs from an oracle forced a keyframe")
    s1 = [(r[0][1], r[1][1]) for r in brun]
    if s1[4:6] != [(empty, False)] * 2 or not s1[6][1]:
        _fail(f"phase 14 (b): the parked session gave {s1[4:7]}")
    if [x for x, _ in s1[6:]] != _fleet_solo(bases, 1, range(6, FLEET_TICKS), W, H):
        _fail("phase 14 (b): the un-parked session differs from a fresh encoder")
    if any(r[0][i] != a[0][i] for r, a in zip(brun, runs["occupancy"]) for i in (2, 3)):
        _fail("phase 14 (b): sessions 2 and 3 differ from (a)")
    want = _fleet_launches_ok(brun, 2, range(FLEET_N))
    if [r[2] for r in brun] != want:
        _fail(f"phase 14 (b): launches {[r[2] for r in brun]}, want {want}")
    rec.update(idrs=[r[1] for r in brun], launches_per_tick=[r[2] for r in brun],
               seconds=time.perf_counter() - t0)
    out["b"] = rec
    print(f"phase 14 (b) checkpoint + re-carve of session 0 after tick 3: its AUs equal an "
          f"oracle forced a keyframe at tick 4 (re-carve {rec['recarve_ms']:.1f} ms); session "
          f"1 parked at ticks 4-5 gave b'' and no IDR, un-parked at tick 6 as a fresh IDR equal "
          f"to a new encoder's; launches {rec['launches_per_tick']}; {rec['seconds']:.1f} s")

    # (c) mixed tenancy: 4 batch sessions and 2 banded ones of 1920x1088
    t0 = time.perf_counter()
    mbases = _fleet_bases(6, SW, SH)
    mixed_runs = {}
    for env in ("0", "1"):
        os.environ["SELKIES_OCCUPANCY"] = env
        mixed = MixedTenancyService(
            TorchMultiSessionH264Service(4, SW, SH, qp=28, device="cuda"),
            TorchBandedFleetService(2, SW, SH, qp=28, bands=2))
        me_mc.launches = 0
        run = _drive_fleet(mixed, mixed.encode_tick, mbases, range(MIXED_TICKS), MIXED_OPS)
        mixed_runs[env] = (run, me_mc.launches, mixed.scheduler() is not None,
                           mixed.scheduler().stats() if mixed.scheduler() else None)
        mixed.close()
    off, on = mixed_runs["0"], mixed_runs["1"]
    if off[2] or not on[2]:
        _fail("phase 14 (c): SELKIES_OCCUPANCY did not pick the serial / scheduled tick")
    if [r[:2] for r in off[0]] != [r[:2] for r in on[0]]:
        _fail("phase 14 (c): mixed tenancy AUs differ between occupancy off and on")
    for env, (run, *_rest) in mixed_runs.items():
        want = _fleet_launches_ok(run, 2, range(4, 6), range(4))
        if [r[2] for r in run] != want:
            _fail(f"phase 14 (c) occupancy {env}: launches {[r[2] for r in run]}, want {want}")
    out["c"] = {"sha256": [r[0] for r in on[0]], "idrs": [r[1] for r in on[0]],
                "launches_per_tick": {"off": [r[2] for r in off[0]],
                                      "on": [r[2] for r in on[0]]},
                "tick_ms": {"off": [r[3] for r in off[0]], "on": [r[3] for r in on[0]]},
                "me_mc_launches": {"off": off[1], "on": on[1]}, "stats": on[3],
                "seconds": time.perf_counter() - t0}
    print(f"phase 14 (c) MixedTenancyService(4 x {SW}x{SH} batch, 2 x bands=2): AUs "
          f"sha256-equal with occupancy off and on over {MIXED_TICKS} ticks; me_mc launches "
          f"per tick {out['c']['launches_per_tick']['on']} (1 for the batch unit + 2 per banded "
          f"P); {out['c']['seconds']:.1f} s")

    # (d) sched:1@3:drop and sched:2@4:raise on (a)'s service
    t0 = time.perf_counter()
    spec = "sched:1@3:drop;sched:2@4:raise"
    fi = faultinject.configure_faults(spec)
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
    sched = OccupancyScheduler.for_service(svc)
    errors = {}

    def sched_tick(batch):
        try:
            return sched.encode_tick(batch)
        except faultinject.InjectedFault:
            errors[sched.ticks] = sorted(sched.stats()["errors"])
            raise

    drun = _drive_fleet(svc, sched_tick, bases)
    faultinject.reset_faults()
    sched.close()
    svc.close()
    injected = [tuple(x) for x in fi.injected]
    if injected != [("sched:1", 3, "drop"), ("sched:2", 4, "raise")]:
        _fail(f"phase 14 (d): injected {injected}")
    if drun[3][0] != "InjectedFault" or errors != {4: ["2"]}:
        _fail(f"phase 14 (d): tick 3 gave {drun[3][0]}, errors {errors}")
    if drun[2][0][1] != empty:
        _fail("phase 14 (d): the dropped tick delivered an AU")
    a_rows = [r[0] for r in runs["occupancy"]]
    for t in range(FLEET_TICKS):
        if t == 3:
            continue
        others = [0, 3] + ([1] if t < 2 else []) + ([2] if t < 3 else [])
        if any(drun[t][0][i] != a_rows[t][i] for i in others):
            _fail(f"phase 14 (d): tick {t}: a session without a fault differs from (a)")
    keep1 = [t for t in range(FLEET_TICKS) if t != 2]
    if [drun[t][0][1] for t in keep1 if t != 3] != [
            x for t, x in zip(keep1, _fleet_solo(bases, 1, keep1, W, H)) if t != 3]:
        _fail("phase 14 (d): the dropped session differs from an oracle that never saw tick 2")
    keep2 = [t for t in range(FLEET_TICKS) if t != 3]
    if [drun[t][0][2] for t in keep2] != _fleet_solo(bases, 2, keep2, W, H):
        _fail("phase 14 (d): the raised session differs from an oracle that never saw tick 3")
    out["d"] = {"spec": spec, "injected": injected, "errors": errors,
                "seconds": time.perf_counter() - t0}
    print(f"phase 14 (d) {spec}: session 1's tick 2 AU empty and its later frames equal an "
          f"oracle without that frame; tick 3 raised InjectedFault after the other sessions "
          f"ran (errors {errors}), session 2 then equals an oracle without frame 3; every "
          f"other session as (a); {out['d']['seconds']:.1f} s")

    # (e) the placer over the pool's one card, admission, and a drain with
    # the service's force-keyframe, flush and hand-off
    t0 = time.perf_counter()
    _set_hooks(True)
    placer = SessionPlacer(bands=2)
    rows = placer.place_initial(FLEET_N, 2)
    if not placer.shared or rows != [[card]] * FLEET_N or placer.devices != [card]:
        _fail(f"phase 14 (e): placer carve {rows}, shared {placer.shared}")
    adm = placer.admit(FLEET_N)
    if (adm.decision, adm.reason) != ("accept", "shared"):
        _fail(f"phase 14 (e): admission {adm}")
    svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2, rows=rows, shared=True)
    sched = OccupancyScheduler.for_service(svc)
    for t in range(2):
        sched.encode_tick(_fleet_batch(bases, t))

    async def flush():
        await asyncio.get_running_loop().run_in_executor(
            None, sched.encode_tick, _fleet_batch(bases, 2))

    drainer = DrainController(
        "fleet", placer=placer, deadline_s=120.0,
        force_idr=lambda: [svc.force_keyframe(k) for k in range(FLEET_N)], flush=flush,
        handoff=lambda: [checkpoint_session(svc, k) for k in range(FLEET_N)])
    ok = asyncio.run(drainer.drain())
    cks = [(c.session, c.idr_pic_id, c.frames_since_idr, c.qp) for c in drainer.checkpoints]
    health = telemetry.health()["status"]
    late = placer.admit(FLEET_N + 1)
    drain_gauge = telemetry._gauges.get(("selkies_drain_state", ()))
    sched.close()
    svc.close()
    telemetry._lifecycle = None
    _set_hooks(False)
    if not ok or not drainer.completed_in_deadline or svc.last_idrs != [True] * FLEET_N:
        _fail(f"phase 14 (e): drain ok {ok}, in deadline {drainer.completed_in_deadline}, "
              f"IDRs {svc.last_idrs}")
    if cks != [(k, 0, 1, 28) for k in range(FLEET_N)]:
        _fail(f"phase 14 (e): checkpoints {cks}")
    if health != "draining" or (late.decision, late.reason) != ("reject", "draining") \
            or drain_gauge != 2:
        _fail(f"phase 14 (e): health {health}, late admission {late}, gauge {drain_gauge}")
    out["e"] = {"carve": placer.stats()["carve"], "checkpoints": cks,
                "drain_s": time.perf_counter() - t0}
    print(f"phase 14 (e) SessionPlacer(devices=None): shared carve of {FLEET_N} sessions on "
          f"the pool's one card, admission accepted (shared); drain: forced IDRs flushed, "
          f"{len(cks)} checkpoints, completed in deadline, then health 'draining' and "
          f"admission rejected; {out['e']['drain_s']:.1f} s")
    if env0 is None:
        os.environ.pop("SELKIES_OCCUPANCY", None)
    else:
        os.environ["SELKIES_OCCUPANCY"] = env0
    return out


# -- phase 15: the tile-column codec mesh, the library rows, the software fleet

MESH_COLS = (1, 2, 4, 7)  # 7 pads 1920 to 2016 px
LIBRARY_ROWS = (("x264enc", "x264"), ("x265enc", "x265"), ("nvh265enc", "x265"),
                ("svtav1enc", "svt"))
SW_N, SW_TICKS = 4, 6
# tick -> ops before it: ("qp", session, qp) / ("key", session)
SW_OPS = {2: [("qp", 1, 32)], 3: [("key", 2)]}


def _library_loads(lib: str) -> bool:
    from selkies_tpu_torch.models import libaom_enc, libvpx_enc, svt_av1_enc, x264enc, x265enc

    return {"x264": x264enc.x264_available, "x265": x265enc.x265_available,
            "svt": svt_av1_enc.svt_av1_available, "libvpx": libvpx_enc.libvpx_available,
            "libaom": libaom_enc.libaom_available,
            "aom_strip": libaom_enc.aom_strip_available}[lib]()


def _drive_mesh(fe, trace):
    steps = []
    for frame, op, _ in trace:
        if op == "key":
            fe.reset()
        steps.append(fe.step(frame))
    return steps


def _drive_sw_fleet(svc, bases, ticks=range(SW_TICKS)):
    """-> per tick (the sessions' AU sha256s, last_idrs, the encoders'
    upload kinds, K1 launches, the tick's host ms)."""
    from selkies_tpu_torch.models.h264 import me_mc

    out = []
    for t in ticks:
        for op in SW_OPS.get(t, ()):
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
        k0 = me_mc.launches
        t0 = time.perf_counter()
        aus = svc.encode_tick(_fleet_batch(bases, t))
        tick_ms = (time.perf_counter() - t0) * 1e3
        out.append(([hashlib.sha256(au).hexdigest() for au in aus], list(svc.last_idrs),
                    [getattr(e.last_stats, "upload_kind", "") for e in svc.encoders],
                    me_mc.launches - k0, tick_ms))
    return out


def _mesh_phase() -> dict:
    """(a) MeshDeltaFrontend on the card against the CPU at cols 1, 2, 4, 7;
    (b) the registry's mesh routes; (c) the library rows; (d)
    SoftwareFleetService; (e) the fleet's AV1/VP9 sessions."""
    import torch

    from selkies_tpu_torch.models import libvpx_enc
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.models.registry import create_encoder
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.parallel.codec_mesh import (
        MeshDeltaFrontend,
        TileColumnAV1Encoder,
        TileColumnVP9Encoder,
    )
    from selkies_tpu_torch.parallel.serving import SoftwareFleetService, TorchBandedFleetService

    trace = _hybrid_trace()
    out: dict = {}
    # (a) the mesh front-end, a reset at the keyframe
    solo = [d for d, _ in _drive_mesh(DeviceDeltaFrontend(W, H, device="cuda"), trace)]
    out["frontend"] = {}
    for cols in MESH_COLS:
        runs = {}
        for dev in ("cuda", "cpu"):
            fe = MeshDeltaFrontend(W, H, cols, devices=[torch.device(dev)])
            runs[dev] = (_drive_mesh(fe, trace), fe.votes, fe.pad_w)
        (g, votes, pad_w), (c, cpu_votes, _) = runs["cuda"], runs["cpu"]
        for i, ((gd, gh), (cd, ch), (_, _, kind)) in enumerate(zip(g, c, trace)):
            if cd is None:
                if gd is not None or gh is not None:
                    _fail(f"phase 15 (a) cols={cols} frame {i}: a map where the cpu gave none")
                continue
            if (gd.shape != ((H + 15) // 16, (W + 15) // 16) or gd.dtype != cd.dtype
                    or gh.dtype != ch.dtype
                    or not np.array_equal(gd, cd) or not np.array_equal(gh, ch)):
                _fail(f"phase 15 (a) cols={cols} frame {i} ({kind}): the card's map or hints "
                      "differ from the cpu's")
            if kind == "static" and cd.any():
                _fail(f"phase 15 (a) cols={cols} frame {i}: a static frame is dirty")
            if cols == 1 and not np.array_equal(gd, solo[i]):
                _fail(f"phase 15 (a) frame {i}: cols=1's map differs from DeviceDeltaFrontend's")
        stepped = sum(1 for d, _ in g if d is not None)
        if votes != cpu_votes or votes != stepped:
            _fail(f"phase 15 (a) cols={cols}: {votes} votes on the card, {cpu_votes} on the "
                  f"cpu, for {stepped} steps (the vote runs on every step)")
        out["frontend"][f"cols{cols}"] = {
            "pad_w": pad_w, "votes": votes,
            "dirty_mbs": [None if d is None else int(d.sum()) for d, _ in g],
            "hints": [None if h is None else h.tolist() for _, h in g]}
    print(f"phase 15 (a) MeshDeltaFrontend {W}x{H} at cols {list(MESH_COLS)} (pad_w "
          f"{[v['pad_w'] for v in out['frontend'].values()]}): the card's dirty maps and hints "
          f"equal the cpu run's on {len(trace)} frames, static steps voting too "
          f"({out['frontend']['cols2']['votes']} votes each); cols=1's maps equal "
          "DeviceDeltaFrontend's")

    # (b) the registry's mesh routes, cols=2, frontend="device"
    for row, lib in (("tpuvp9enc", "libvpx"), ("tpuav1enc", "aom_strip")):
        if not _library_loads(lib):
            if row == "tpuav1enc":
                # JAX's degrade: without libaom tpuav1enc serves tpuh264enc
                enc = create_encoder(row, width=W, height=H, cols=2, frontend="device",
                                     device="cuda")
                name = type(enc).__name__
                enc.close()
                if name != "TorchH264Encoder":
                    _fail(f"phase 15 (b): tpuav1enc without libaom built {name}")
                rec = {"row": row, "cols": 2, "degrade": "tpuh264enc (TorchH264Encoder)"}
            else:
                rec = {"row": row, "cols": 2, "skipped": "libvpx not loadable"}
            print(json.dumps(rec))
            out[row] = rec
            continue
        probed = libvpx_enc._row_mt_state
        libvpx_enc._row_mt_state = False  # libvpx repeats itself with row-mt off
        shas = {}
        try:
            for dev in ("cuda", "cpu"):
                enc = create_encoder(row, width=W, height=H, cols=2, frontend="device",
                                     device=dev)
                if enc.cols != 2 or not isinstance(enc._device_fe, MeshDeltaFrontend):
                    _fail(f"phase 15 (b): {row} cols=2 is not the tile-column mesh row")
                aus = []
                for frame, op, _ in trace:
                    if op == "key":
                        enc.force_keyframe()
                    aus.append(enc.encode_frame(frame))
                enc.close()
                shas[dev] = [hashlib.sha256(au).hexdigest() for au in aus]
        finally:
            libvpx_enc._row_mt_state = probed
        if shas["cuda"] != shas["cpu"]:
            _fail(f"phase 15 (b): {row} cols=2 on the card differs from the cpu run")
        out[row] = {"cols": 2, "sha256": shas["cuda"]}
        print(f"phase 15 (b) {row} cols=2 frontend device: {len(trace)} AUs sha256-equal the "
              "cpu run's")

    # (c) the library rows over phase 12's typing trace
    typing = [(f, None) for f in _typing_run(12, 300)]
    direct = create_encoder("tpuh264enc", width=W, height=H, fps=60, bitrate_kbps=2000,
                            device="cuda")
    want, _ = _drive_registry(direct, typing)
    direct.close()
    out["library_rows"] = {}
    for name, lib in LIBRARY_ROWS:
        enc = create_encoder(name, width=W, height=H, fps=60, bitrate_kbps=2000, device="cuda")
        cls = type(enc).__name__
        if cls != "TorchH264Encoder":
            # the library loads (or svtav1enc's degrade is the AV1 row)
            sizes, kinds = [], []
            for frame, _ in typing:
                sizes.append(len(enc.encode_frame(frame)))
                kinds.append("idr" if enc.last_stats.idr else "p")
            enc.close()
            rec = {"row": name, "class": cls, "kinds": kinds, "bytes": sizes}
            print(json.dumps(rec))
            out["library_rows"][name] = rec
            continue
        me_mc.launches = 0
        got, _ = _drive_registry(enc, typing)
        torch.cuda.synchronize()
        launches = me_mc.launches
        enc.close()
        if [s for s, _ in got] != [s for s, _ in want]:
            _fail(f"phase 15 (c): {name}'s degrade differs from create_encoder('tpuh264enc')")
        p_frames = sum(1 for _, st in got if not st.idr and st.upload_kind != "static")
        if launches != p_frames:
            _fail(f"phase 15 (c): {name} launched me_mc {launches} times for {p_frames} P frames")
        out["library_rows"][name] = {"row": name, "degrade": "tpuh264enc", "frames": len(got),
                                     "p_frames": p_frames, "me_mc_launches": launches}
    degraded = {k: v["me_mc_launches"] for k, v in out["library_rows"].items()
                if "degrade" in v}
    out["library_launches"] = sum(degraded.values())
    print(f"phase 15 (c) library rows at {W}x{H}: {sorted(degraded)} serve tpuh264enc (library "
          f"missing), {len(typing)} AUs each sha256-equal create_encoder('tpuh264enc'); me_mc "
          f"launched {degraded} (once per non-static P frame)")

    # (d) SoftwareFleetService(4, 1920, 1080) against solo registry rows
    bases = _fleet_bases(SW_N, W, H)
    svc = SoftwareFleetService(SW_N, W, H, device="cuda")
    cls = type(svc.encoders[0]).__name__
    me_mc.launches = 0
    run = _drive_sw_fleet(svc, bases)
    torch.cuda.synchronize()
    launches = me_mc.launches
    # the timing block's ticks: 6 more P ticks of full motion on this service
    p_ms = []
    for t in range(SW_TICKS, SW_TICKS + 6):
        batch = np.stack(_scrolled(bases, t))
        t0 = time.perf_counter()
        svc.encode_tick(batch)
        p_ms.append((time.perf_counter() - t0) * 1e3)
    svc.close()
    if cls == "TorchH264Encoder":
        for i in range(SW_N):
            enc = create_encoder("x264enc", width=W, height=H, fps=60, bitrate_kbps=2000,
                                 qp=28, device="cuda")
            qp, shas = 28, []
            for t in range(SW_TICKS):
                for op in SW_OPS.get(t, ()):
                    if op[1] == i and op[0] == "qp":
                        qp = op[2]
                        enc.set_qp(qp)
                    elif op[1] == i:
                        enc.force_keyframe()
                shas.append(hashlib.sha256(enc.encode_frame(_fleet_frame(bases, i, t), qp))
                            .hexdigest())
            enc.close()
            if shas != [r[0][i] for r in run]:
                _fail(f"phase 15 (d): session {i} differs from a solo registry-row encoder")
        want_k1 = [sum(1 for idr, kind in zip(r[1], r[2]) if not idr and kind != "static")
                   for r in run]
        if [r[3] for r in run] != want_k1 or launches != sum(want_k1):
            _fail(f"phase 15 (d): me_mc launches per tick {[r[3] for r in run]} != {want_k1}")
    out["software_fleet"] = {"class": cls, "me_mc_launches": launches,
                             "launches_per_tick": [r[3] for r in run],
                             "idrs": [r[1] for r in run], "kinds": [r[2] for r in run],
                             "tick_ms": [r[4] for r in run],
                             "timing": {"sessions": SW_N, "idr_tick_ms": run[0][4],
                                        "p_tick_ms_full_motion": p_ms,
                                        "p_tick_ms_median": statistics.median(p_ms),
                                        "fps": SW_N * 1e3 / statistics.median(p_ms)}}
    print(f"phase 15 (d) SoftwareFleetService({SW_N}, {W}, {H}): sessions are {cls}"
          + (" (libx264 missing): each session's AUs sha256-equal a solo registry-row encoder "
             "fed the same frames, QPs and keyframes" if cls == "TorchH264Encoder" else "")
          + f"; me_mc launches per tick {[r[3] for r in run]}")

    # (e) the banded fleet's AV1 session and a switch to VP9
    fb = _fleet_bases(2, W, H)
    fleet = TorchBandedFleetService(2, W, H, qp=28, bands=2, codecs=["h264", "av1"])
    codec_after = {}
    oracle_cls = {"av1": TileColumnAV1Encoder, "vp9": TileColumnVP9Encoder}

    def oracle(codec):
        if fleet.codecs[1] == "h264":
            return TorchBandedH264Encoder(W, H, qp=28, bands=2, device="cuda")
        return oracle_cls[codec](W, H, fps=60, cols=1, frontend=fleet.encoders[1].frontend_mode,
                                 device="cpu")

    codec_after["av1"] = (fleet.codecs[1], type(fleet.encoders[1]).__name__)
    orc, got_s, want_s, k1, want_k1 = oracle("av1"), [], [], [], []
    me_mc.launches = 0
    for t in range(5):
        if t == 3:
            fleet.set_codec(1, "vp9")
            fleet.recarve(1, [torch.device("cuda", 0)])
            codec_after["vp9"] = (fleet.codecs[1], type(fleet.encoders[1]).__name__)
            orc.close()
            orc = oracle("vp9")
        # the fleet's own launches: the count is read around its tick only,
        # since an h264 oracle launches K1 on the card too
        k0 = me_mc.launches
        aus = fleet.encode_tick(np.stack([_fleet_frame(fb, i, t) for i in range(2)]))
        k1.append(me_mc.launches - k0)
        # bands x cols per banded h264 session that coded a non-static P frame
        want_k1.append(sum(e.bands * e.cols for i, e in enumerate(fleet.encoders)
                           if isinstance(e, TorchBandedH264Encoder) and not fleet.last_idrs[i]
                           and e.last_stats.upload_kind != "static"))
        got_s.append(hashlib.sha256(aus[1]).hexdigest())
        want_s.append(hashlib.sha256(orc.encode_frame(_fleet_frame(fb, 1, t))).hexdigest())
    launches = sum(k1)
    orc.close()
    fleet.close()
    for codec, lib in (("av1", "aom_strip"), ("vp9", "libvpx")):
        loads = _library_loads(lib)
        if (codec_after[codec][0] == "h264") == loads:
            _fail(f"phase 15 (e): the {codec} session built {codec_after[codec]} with the "
                  f"library {'loading' if loads else 'missing'}")
    if got_s != want_s:
        _fail("phase 15 (e): the AV1/VP9 session's AUs differ from its oracle's")
    if k1 != want_k1:
        _fail(f"phase 15 (e): the fleet's me_mc launches per tick {k1}, want {want_k1}")
    out["fleet_codecs"] = {"after": codec_after, "me_mc_launches": launches,
                           "launches_per_tick": k1}
    print(f"phase 15 (e) TorchBandedFleetService(2, {W}, {H}, bands=2, codecs=['h264', 'av1']) "
          f"and set_codec(1, 'vp9') + recarve: session 1 is {codec_after} (codec record, "
          f"encoder); its AUs sha256-equal the matching oracle; the fleet's ticks launched "
          f"me_mc {k1} (bands x cols per non-static banded P session), {launches} in all")
    return out


def _time_mesh(card: str, power_limit: str) -> dict:
    """MeshDeltaFrontend's step per frame kind at cols 1, 2 and 4 against
    DeviceDeltaFrontend (host clock around the synchronised step), with
    device ops and idle share over 8 static and 8 changed steps
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.models.hybrid_frontend import DeviceDeltaFrontend
    from selkies_tpu_torch.parallel.codec_mesh import MeshDeltaFrontend

    trace = _hybrid_trace()
    rng = np.random.default_rng(2043)
    a, t1, win, scroll = trace[0][0], trace[3][0], trace[5][0], trace[6][0]
    noise = [rng.integers(0, 255, (H, W, 4), np.uint8) for _ in range(2)]
    pairs = {"static": (a, a), "typing": (a, t1), "scroll": (win, scroll),
             "full": (noise[0], noise[1])}
    n, warm = 8, 2
    out: dict = {"card": card, "power_limit": power_limit, "steps": n}
    fes = {"solo": DeviceDeltaFrontend(W, H, device="cuda")}
    fes.update({f"cols{c}": MeshDeltaFrontend(W, H, c, devices=[torch.device("cuda", 0)])
                for c in (1, 2, 4)})
    for name, fe in fes.items():
        out[name] = {}
        for kind, (f0, f1) in pairs.items():
            feed = [f1 if i % 2 == 0 else f0 for i in range(warm + n)]
            fe.reset()
            fe.step(f0)
            step_ms = []
            for f in feed:
                fe.step(f)
                step_ms.append(fe.last_device_ms)
            out[name][kind] = {"step_ms": statistics.median(step_ms[warm:])}
            if kind not in ("static", "full"):
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for f in feed[:8]:
                    fe.step(f)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            act = _device_activity(prof, wall_ms)
            if isinstance(act.get("device_ops"), int):
                act["device_ops_per_step"] = act["device_ops"] / 8
            act.pop("top", None)
            out[name][kind]["profile_8_steps"] = act
    return out


def _timed(obj, name: str, sink: list) -> None:
    """Wrap obj.name so each call appends its host-clock ms to sink."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, wrapper)


def _time_fleet(card: str, power_limit: str, pairs: int = 3, p_ticks: int = 6) -> dict:
    """Phase 14's (a) and (c) configurations on full motion (_scrolled):
    occupancy off and on in alternating pairs on one service (off, on, on,
    off, ...; the banded service also runs its sessions one after another,
    "in_turn", after each pair), p_ticks P ticks each; per run the median
    tick ms, fps across sessions, the dispatch and complete ms per unit
    (host clock), and with it on the scheduler's overlap and sched_wait
    (the median of each tick's, and the scheduler's EWMA, which still
    carries the IDR tick); then the device ops and idle share per tick
    over 3 ticks each way (torch.profiler), and for the banded service the
    ms from a checkpoint to the first AU after a re-carve."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from selkies_tpu_torch.parallel.occupancy import MixedTenancyService, OccupancyScheduler
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )

    env0 = os.environ.get("SELKIES_OCCUPANCY")
    out: dict = {"card": card, "power_limit": power_limit}
    for name in ("banded_4x1080_bands2", "mixed_4batch_2banded_1088"):
        if name.startswith("banded"):
            bases = _fleet_bases(FLEET_N, W, H)
            svc = TorchBandedFleetService(FLEET_N, W, H, qp=28, bands=2)
            sched = OccupancyScheduler.for_service(svc)
            banded, batch = svc, None

            def tick(frames, mode):
                if mode == "in_turn":  # the serial tick's work, one session after another
                    return [e.encode_frame(f) for e, f in zip(svc.encoders, frames)]
                return (sched if mode == "on" else svc).encode_tick(frames)

            def scheduler():
                return sched
        else:
            bases = _fleet_bases(6, SW, SH)
            batch = TorchMultiSessionH264Service(4, SW, SH, qp=28, device="cuda")
            banded = TorchBandedFleetService(2, SW, SH, qp=28, bands=2)
            svc = MixedTenancyService(batch, banded)

            def tick(frames, mode):
                os.environ["SELKIES_OCCUPANCY"] = "1" if mode == "on" else "0"
                return svc.encode_tick(frames)

            def scheduler():
                return svc.scheduler()
        n = len(bases)
        times: dict = {}
        for k, enc in enumerate(banded.encoders):
            for m in ("dispatch_frame", "complete_frame"):
                _timed(enc, m, times.setdefault(f"banded{k}.{m.split('_')[0]}", []))
        if batch is not None:
            for m in ("dispatch_tick", "complete_tick"):
                _timed(batch, m, times.setdefault(f"batch.{m.split('_')[0]}", []))
        # warm-up: the IDR tick scheduled, two serial P ticks, one scheduled
        t0 = time.perf_counter()
        tick(np.stack(_scrolled(bases, 0)), "on")
        rec = {"sessions": n, "idr_tick_ms_occupancy": (time.perf_counter() - t0) * 1e3}
        for t in (1, 2):
            tick(np.stack(_scrolled(bases, t)), "off")
        tick(np.stack(_scrolled(bases, 3)), "on")
        # each tick's sched_wait per session, as the scheduler notes it
        waits: list = []
        note = scheduler()._note_tick

        def noting(wall_s, stage_s, w, errors):
            waits.append(dict(w))
            return note(wall_s, stage_s, w, errors)

        scheduler()._note_tick = noting
        t = 4
        # alternating off / on pairs; the banded service also runs its
        # sessions one after another ("in_turn") after each pair
        turn = ["in_turn"] if name.startswith("banded") else []
        modes = [m for i in range(pairs) for m in (["off", "on"] if i % 2 == 0
                                                   else ["on", "off"]) + turn]
        runs = {m: [] for m in ("off", "on", *turn)}
        for mode in modes:
            frames = [np.stack(_scrolled(bases, t + j)) for j in range(p_ticks)]
            t += p_ticks
            for v in times.values():
                v.clear()
            waits.clear()
            ms, overlaps = [], []
            tw = time.perf_counter()
            for f in frames:
                tt = time.perf_counter()
                tick(f, mode)
                ms.append((time.perf_counter() - tt) * 1e3)
                if mode == "on":
                    overlaps.append(scheduler().last_overlap)
            wall = time.perf_counter() - tw
            r = {"tick_ms_median": statistics.median(ms), "fps": n * p_ticks / wall,
                 "unit_ms_median": {k: statistics.median(v) for k, v in times.items() if v}}
            if mode == "on":
                st = scheduler().stats()
                r.update(last_overlap_median=statistics.median(overlaps),
                         overlap_ewma=st["overlap_ratio"],
                         sched_wait_ms_median={s: statistics.median(w[s] for w in waits)
                                               for s in sorted(waits[0])},
                         sched_wait_ms_ewma=st["sched_wait_ms"])
            runs[mode].append(r)
        rec["runs"] = runs
        for mode in ("off", "on"):
            frames = [np.stack(_scrolled(bases, t + j)) for j in range(3)]
            t += 3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tw = time.perf_counter()
                for f in frames:
                    tick(f, mode)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - tw) * 1e3
            act = _device_activity(prof, wall_ms)
            act["ticks"] = 3
            if isinstance(act.get("device_ops"), int):
                act["device_ops_per_tick"] = act["device_ops"] / 3
            act.pop("top", None)
            rec[f"profile_{mode}"] = act
        if name.startswith("banded"):
            dev = torch.device("cuda", 0)
            rc = []
            for _ in range(3):
                frames = np.stack(_scrolled(bases, t))
                t += 1
                tr = time.perf_counter()
                svc.recarve(0, [dev])
                tb = time.perf_counter()
                sched.encode_tick(frames)
                rc.append({"recarve_ms": (tb - tr) * 1e3,
                           "checkpoint_to_first_au_ms": (time.perf_counter() - tr) * 1e3})
            rec["recarve"] = rc
            sched.close()
        svc.close()
        out[name] = rec
    if env0 is None:
        os.environ.pop("SELKIES_OCCUPANCY", None)
    else:
        os.environ["SELKIES_OCCUPANCY"] = env0
    return out


# -- phase 16: the solo serving app -------------------------------------------

APP_FRAMES = 120
APP_KBPS = 8000
APP_SEED = 16
APP_CPU_FRAMES = 13
# the ladder on the encoder site (ticks as the site counts them, one per
# tick here): four bursts with six healthy ticks between them. Under a
# frozen supervisor clock the first burst's sixth failure restarts the
# encoder once; each later burst of 12 takes one degrade level (1: half
# the framerate, 2: 960x528, 3: the software row); then ten healthy ticks
# reverse each level
LADDER_SPEC = "encoder@9-14,21-32,39-50,57-68:raise"
LADDER_RECOVER = 10
LADDER_TICKS = 104
APP_TIMING_S = 4.0


class _AppTransport:
    """The app's byte plane: each video frame with the host clock at send,
    and the data-channel messages."""

    data_channel_ready = True

    def __init__(self):
        self.frames, self.sent_at, self.messages = [], [], []

    def send_data_channel(self, message: str) -> None:
        self.messages.append(message)

    async def send_video(self, frame) -> None:
        self.sent_at.append(time.perf_counter())
        self.frames.append(frame)


class _StampedSource:
    """A frame source that stamps the host clock as each capture begins."""

    def __init__(self, inner):
        self.inner, self.captured_at = inner, []

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def capture(self):
        self.captured_at.append(time.perf_counter())
        return self.inner.capture()


_PENDING = object()  # a logged call that has not returned yet


class _RecordingEncoder:
    """Stands in for an encoder the app built: forwards every attribute;
    logs each call that feeds or steers the stream, with what it returned,
    and each attribute set on it; counts K1's launches inside its calls
    (the prewarm's apart) and the host ms from its build to its first AU.
    A call takes its place in the log when it starts (a ``force_keyframe``
    from the event loop that lands while a worker's ``submit`` runs is
    ordered after that submit, whose frame kind was already decided), and
    ``_PENDING`` stands for its return until it returns. A close drops the
    encoder itself (the log replays without it), so the recording keeps no
    closed encoder's device memory alive."""

    CALLS = ("submit", "encode_frame", "flush", "force_keyframe", "prewarm", "close",
             "set_tile_cache", "set_batch_cap", "retune_entropy")

    def __init__(self, enc, name: str, kw: dict, build_ms: float):
        self.__dict__.update(enc=enc, cls=type(enc).__name__, name=name, kw=kw, log=[],
                             launches=0, prewarm_launches=0, build_ms=build_ms,
                             t_built=time.perf_counter(), first_au_ms=None)

    def __getattr__(self, attr):
        from selkies_tpu_torch.models.h264 import me_mc

        val = getattr(self.enc, attr)
        if attr not in self.CALLS:
            return val

        def call(*a, **k):
            k0 = me_mc.launches
            entry = [attr, a, k, _PENDING]
            self.log.append(entry)
            try:
                entry[3] = out = val(*a, **k)
            except Exception as exc:
                entry[3] = exc
                raise
            finally:
                key = "prewarm_launches" if attr == "prewarm" else "launches"
                self.__dict__[key] += me_mc.launches - k0
            if self.first_au_ms is None and _returned(attr, out):
                self.__dict__["first_au_ms"] = (time.perf_counter() - self.t_built) * 1e3
            if attr == "close":
                self.__dict__["enc"] = None
            return out
        return call

    def __setattr__(self, attr, value):
        setattr(self.enc, attr, value)
        self.log.append(("set", attr, value, None))

    def outputs(self) -> list:
        """Every (au, stats, meta) the encoder handed back, in order."""
        return [o for attr, _, _, out in self.log
                if not isinstance(out, Exception) and out is not _PENDING
                for o in _returned(attr, out)]


def _mem() -> dict:
    """The card's resident and peak allocated MiB, after a collection
    (the app's objects form cycles)."""
    import gc

    import torch

    if not torch.cuda.is_available():
        return {}
    gc.collect()
    return {"allocated_mb": torch.cuda.memory_allocated() / 2**20,
            "peak_mb": torch.cuda.max_memory_allocated() / 2**20}


def _returned(attr, out) -> list:
    if attr in ("submit", "flush"):
        return list(out)
    if attr == "encode_frame":
        return [(out, None, None)]
    return []


def _replay(rec, submits: int | None = None, **overrides) -> list:
    """Build rec's row again with its arguments (``overrides`` replace
    some), feed it the logged calls (only the first ``submits`` submits,
    if given) and flush it -> every (sha256, meta) it hands back. The
    first prewarm is left out (a prewarmed row codes as a fresh one); a
    later one (a session restart) resets the GOP and is replayed; a logged
    close ends the calls: the close discarded the frames then in flight,
    which depends on the clock, so a closed encoder's AUs are the head of
    its replay's."""
    from selkies_tpu_torch.models.registry import create_encoder

    enc = create_encoder(rec.name, **dict(rec.kw, **overrides))
    outs, n = [], 0
    try:
        for attr, a, k, out in rec.log:
            if attr == "close":
                break
            if attr == "prewarm":
                if n:
                    enc.prewarm()
                continue
            if attr == "set":
                setattr(enc, a, k)
                continue
            if submits is not None and attr == "submit" and n == submits:
                break
            n += attr == "submit"
            outs += _returned(attr, getattr(enc, attr)(*a, **k))
        outs += enc.flush()
    finally:
        enc.close()
    return [(hashlib.sha256(au).hexdigest(), m) for au, _, m in outs]


def _shas(rec) -> list:
    return [(hashlib.sha256(au).hexdigest(), m) for au, _, m in rec.outputs()]


def _sps_size(au: bytes) -> tuple[int, int]:
    """(width, height) an Annex-B AU's leading SPS codes, cropping applied."""
    nal = au.split(b"\x00\x00\x00\x01")[1]
    if nal[0] & 0x1F != 7:
        _fail(f"phase 16: an encoder's first AU starts with NAL type {nal[0] & 0x1F}, not an SPS")
    rbsp = nal[1:].replace(b"\x00\x00\x03", b"\x00\x00")
    bits = "".join(f"{b:08b}" for b in rbsp)
    pos = 24  # profile_idc, constraint flags, level_idc

    def u(n):
        nonlocal pos
        pos += n
        return int(bits[pos - n:pos], 2) if n else 0

    def ue():
        nonlocal pos
        z = bits.index("1", pos) - pos
        pos += z + 1
        return (1 << z) - 1 + u(z)

    ue()  # seq_parameter_set_id (Baseline / Main: no chroma_format_idc)
    ue()  # log2_max_frame_num_minus4
    if ue() == 0:  # pic_order_cnt_type
        ue()
    ue()  # max_num_ref_frames
    u(1)
    w_mbs, h_mbs = ue() + 1, ue() + 1
    u(2)  # frame_mbs_only (1 here), direct_8x8_inference
    crop = [ue() for _ in range(4)] if u(1) else [0, 0, 0, 0]
    return 16 * w_mbs - 2 * (crop[0] + crop[1]), 16 * h_mbs - 2 * (crop[2] + crop[3])


def _p_count(outs) -> int:
    return sum(1 for _, st, _ in outs if st is not None and not st.idr
               and st.upload_kind != "static")


def _make_app(dev, framerate: int = 60, source=None):
    """TorchWebRTCApp on the registry's tpuh264enc row (``dev`` None: the
    card) over SyntheticSource(W, H, APP_SEED)."""
    from selkies_tpu_torch.pipeline.app import TorchWebRTCApp
    from selkies_tpu_torch.pipeline.elements import SyntheticSource

    return TorchWebRTCApp(
        source=source or SyntheticSource(W, H, seed=APP_SEED), transport=_AppTransport(),
        encoder="tpuh264enc", framerate=framerate, video_bitrate_kbps=APP_KBPS, device=dev)


def _record_builds(mem: list | None = None):
    """Record every encoder the serving app builds -> (recorders, restore),
    ``restore`` undoing the recording. With ``mem``, the card's memory is
    appended there before each build."""
    from selkies_tpu_torch.pipeline import app as app_mod

    built, real = [], app_mod.create_encoder

    def create(name, **kw):
        if mem is not None:
            mem.append(_mem())
        t0 = time.perf_counter()
        enc = real(name, **kw)
        rec = _RecordingEncoder(enc, name, kw, (time.perf_counter() - t0) * 1e3)
        built.append(rec)
        return rec
    app_mod.create_encoder = create
    return built, lambda: setattr(app_mod, "create_encoder", real)


def _recording_app(dev, mem: list | None = None):
    """_make_app with every encoder the app builds recorded -> (app,
    recorders, restore)."""
    built, restore = _record_builds(mem)
    try:
        app = _make_app(dev)
    except BaseException:
        restore()
        raise
    return app, built, restore


def _serve_app(app, until, timeout_s: float = 180.0, during=None):
    """Serve the app until ``until(app)`` holds (``during``, a coroutine
    function, runs once the first frame is out), then stop it."""
    import asyncio

    async def go():
        await app.start_pipeline()
        t0 = time.perf_counter()
        try:
            if during is not None:
                while not app.transport.frames:
                    await asyncio.sleep(0.002)
                await during(app)
            while not until(app):
                if time.perf_counter() - t0 > timeout_s:
                    _fail(f"phase 16: {len(app.transport.frames)} frames in {timeout_s} s")
                await asyncio.sleep(0.002)
        finally:
            await app.stop_pipeline()
    asyncio.run(go())


def _app_run(dev, label: str) -> dict:
    """(a) / (c): serve APP_FRAMES frames, flush, and hold the AUs against
    a direct card row's replay, the head against a CPU replay, and K1's
    launches against the non-static P frames."""
    app, built, restore = _recording_app(dev)
    t0 = time.perf_counter()
    try:
        _serve_app(app, lambda a: len(a.transport.frames) >= APP_FRAMES)
    finally:
        restore()
    serve_s = time.perf_counter() - t0
    live = built[-1]
    live.flush()
    sent = [f.au for f in app.transport.frames]
    recs = []
    for i, rec in enumerate(built):
        # the live encoder was flushed; a replaced one was closed with its
        # frames in flight discarded, which launched K1 and never came back
        outs = rec.outputs()
        p = _p_count(outs)
        if rec.launches != p if rec is live else rec.launches < p:
            _fail(f"phase 16 ({label}): encoder {i} launched K1 {rec.launches} times for {p} "
                  f"non-static P frames")
        recs.append({"name": rec.name, "size": [rec.kw["width"], rec.kw["height"]],
                     "frames": len(outs), "p_frames": p, "me_mc_launches": rec.launches})
    outs = [o for rec in built for o in rec.outputs()]
    if [au for au, _, _ in outs][:len(sent)] != sent:
        _fail(f"phase 16 ({label}): the sent AUs are not the head of what the encoders returned")
    first = sent[0]
    if not first.startswith(b"\x00\x00\x00\x01\x67") or not app.transport.frames[0].idr \
            or _sps_size(first) != (W, H):
        _fail(f"phase 16 ({label}): the first AU is not an IDR with a {W}x{H} SPS")
    t0 = time.perf_counter()
    for i, rec in enumerate(built):
        got, rep = _shas(rec), _replay(rec, device=rec.kw["device"])
        if rep[:len(got)] != got or (rec is live and len(rep) != len(got)):
            _fail(f"phase 16 ({label}): encoder {i}'s replay on the card differs from the app's AUs")
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _replay(built[0], submits=APP_CPU_FRAMES, device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu != _shas(built[0])[:APP_CPU_FRAMES]:
        _fail(f"phase 16 ({label}): the first {APP_CPU_FRAMES} AUs differ from the CPU replay")
    out = {"sent": len(sent), "returned": len(outs), "encoders": recs,
           "me_mc_launches": sum(r.launches for r in built),
           "p_frames": sum(r["p_frames"] for r in recs),
           "prewarm_launches": built[0].prewarm_launches,
           "qps": sorted({f.qp for f in app.transport.frames}),
           "kinds": {k: sum(1 for _, st, _ in outs if st.upload_kind == k)
                     for k in sorted({st.upload_kind for _, st, _ in outs})},
           "idrs": sum(1 for _, st, _ in outs if st.idr),
           "bytes": sum(len(au) for au in sent), "serve_s": serve_s,
           "card_replay_s": replay_s, "cpu_replay_s": cpu_s, "messages": app.transport.messages,
           "memory": _mem()}
    if app.policy_engine is not None:
        out["policy"] = app.policy_engine.stats()
    if app.slo is not None:
        out["slo"] = app.slo.stats()
    for rec in built:
        rec.log.clear()
    return out


def _ladder_run(dev) -> dict:
    """(b): the recovery ladder under LADDER_SPEC on the flat row (each
    submit hands back its own AU, so every stage's K1 launches are its
    encoder's P frames)."""
    import logging
    import os

    from selkies_tpu_torch.resilience import faultinject

    class _Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    env = {"SELKIES_FRAME_BATCH": "1", "SELKIES_PIPELINE_DEPTH": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    faultinject.reset_faults()
    faultinject.configure_faults(LADDER_SPEC)
    caught = _Warnings()
    logging.getLogger().addHandler(caught)
    events, mem = [], []
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        app, built, restore = _recording_app(dev, mem)
        sup = app.supervisor
        sup.clock = lambda: 0.0
        sup.last_ok = 0.0
        sup.recover_after = LADDER_RECOVER
        for name in ("tick_ok", "failure"):
            orig = getattr(sup, name)

            def wrapped(*a, _o=orig, _n=name, **k):
                r = _o(*a, **k)
                events.append((_n, sup.rung.name, sup.degrade_level, app.encoder.width,
                               app.encoder.height, app.software_fallback, app.framerate,
                               len(built)))
                return r
            setattr(sup, name, wrapped)
        t0 = time.perf_counter()
        try:
            _serve_app(app, lambda a: len(events) >= LADDER_TICKS, timeout_s=300.0)
        finally:
            restore()
        serve_s = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(caught)
        faultinject.reset_faults()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sw, dh = max(16, W // 2 // 16 * 16), max(16, H // 2 // 16 * 16)
    want = [("tpuh264enc", W, H), ("tpuh264enc", W, H), ("tpuh264enc", sw, dh),
            ("x264enc", sw, dh), ("tpuh264enc", sw, dh), ("tpuh264enc", W, H)]
    got = [(r.name, r.kw["width"], r.kw["height"]) for r in built]
    if got != want:
        _fail(f"phase 16 (b): the ladder built {got}, want {want}")
    rungs = [e[1] for e in events]
    levels = [e[2] for e in events]
    if not ("RESTART" in rungs and max(levels) == 3 and levels[-1] == 0
            and events[-1][6] == 60 and not events[-1][5] and any(e[5] for e in events)):
        _fail(f"phase 16 (b): the ladder's events {events}")
    stages = []
    for i, rec in enumerate(built):
        outs = rec.outputs()
        p = _p_count(outs)
        if not outs or _sps_size(outs[0][0]) != tuple(got[i][1:]):
            _fail(f"phase 16 (b): encoder {i} ({got[i]}) did not start with an SPS of its size")
        # libx264, where it loads, codes the software rung: no K1, and its
        # threaded bytes do not repeat, so no replay
        if rec.cls == "TorchH264Encoder":
            if not outs[0][1].idr or rec.launches != p or p == 0:
                _fail(f"phase 16 (b): encoder {i} launched K1 {rec.launches} times for {p} "
                      f"non-static P frames (first frame IDR: {outs[0][1].idr})")
            flat = {k: 1 if k == "frame_batch" else 0 for k in ("frame_batch", "pipeline_depth")}
            if _replay(rec, device=rec.kw["device"], **flat) != _shas(rec):
                _fail(f"phase 16 (b): encoder {i}'s replay on the card differs from the app's AUs")
        stages.append({"encoder": list(got[i]), "frames": len(outs), "p_frames": p,
                       "me_mc_launches": rec.launches, "sps": list(_sps_size(outs[0][0])),
                       "device": str(rec.kw["device"]), "build_ms": rec.build_ms,
                       "first_au_ms": rec.first_au_ms, "memory_before_build": mem[i],
                       "class": rec.cls})
        rec.log.clear()
    degrade = [m for m in caught.messages if "x264enc falls back to tpuh264enc" in m]
    sw_row = stages[3]["class"]
    if sw_row == "TorchH264Encoder" and not degrade:
        _fail("phase 16 (b): the software rung degraded without the registry's warning")
    end = _mem()
    # before a build the encoder it replaces is still alive: builds 1 and 2
    # and the end find one full-size encoder, builds 3-5 one 960x528 one.
    # The closed ones must not pile up.
    if end:
        full = [mem[1]["allocated_mb"], mem[2]["allocated_mb"], end["allocated_mb"]]
        half = [m["allocated_mb"] for m in mem[3:6]]
        if max(full) - min(full) > 2.0 or max(half) - min(half) > 2.0:
            _fail(f"phase 16 (b): resident memory grew across the rebuilds: before builds "
                  f"{[m['allocated_mb'] for m in mem]} MiB, at the end {end['allocated_mb']}")
    return {"events": events, "stages": stages, "software_rung": sw_row,
            "software_fallback_warning": degrade[:1], "serve_s": serve_s,
            "sent": len(app.transport.frames), "memory_end": end}


def _time_app(dev, framerate: int) -> dict:
    """(d): the app at ``framerate``, hooks off: after a warm-up, APP_TIMING_S
    of steady state -> delivered fps, capture->send ms (median, p95, from
    the source's and the transport's stamps, paired in order), dropped
    ticks and frames; then torch.profiler over a few ticks."""
    import asyncio

    from selkies_tpu_torch.pipeline.elements import SyntheticSource

    src = _StampedSource(SyntheticSource(W, H, seed=APP_SEED))
    app = _make_app(dev, framerate=framerate, source=src)
    gate = _Gate()
    app.encoder = _Gated(app.encoder, gate, ENCODER_CALLS)
    win = {}

    async def measure(app):
        while len(app.transport.frames) < 2 * framerate // 3:  # warm-up
            await asyncio.sleep(0.002)
        p = app.pipeline
        win["n0"], win["t0"] = len(app.transport.frames), time.perf_counter()
        win["d0"] = (p.dropped_ticks, p.dropped_frames, p.frames)
        await asyncio.sleep(APP_TIMING_S)
        win["n1"], win["t1"] = len(app.transport.frames), time.perf_counter()
        win["d1"] = (p.dropped_ticks, p.dropped_frames, p.frames)
        ticks = max(3, framerate // 6)
        prof, wall_ms = await _live_profile(gate, lambda: asyncio.sleep(ticks / framerate))
        win["profile"] = _device_activity(prof, wall_ms)
        win["profile"]["ticks"] = ticks

    _serve_app(app, lambda a: "profile" in win, during=measure)
    app.encoder.close()
    t = app.transport
    lat = sorted((t.sent_at[i] - src.captured_at[i]) * 1e3 for i in range(win["n0"], win["n1"]))
    n = len(lat)
    return {"framerate": framerate, "seconds": win["t1"] - win["t0"], "delivered": n,
            "fps": n / (win["t1"] - win["t0"]), "capture_to_send_ms_median": statistics.median(lat),
            "capture_to_send_ms_p95": lat[-(-95 * n // 100) - 1], "capture_to_send_ms_max": lat[-1],
            "dropped_ticks": win["d1"][0] - win["d0"][0],
            "dropped_frames": win["d1"][1] - win["d0"][1],
            "encoded": win["d1"][2] - win["d0"][2], "profile": win["profile"]}


def _time_direct_row(dev, n: int = 150) -> dict:
    """The registry row the app serves, built directly and fed the same
    source's frames back to back with the app's rate controller: frames
    per second and a frame's submit() to the return of its AU."""
    import torch

    from selkies_tpu_torch.models.h264.ratecontrol import CbrRateController
    from selkies_tpu_torch.models.registry import create_encoder
    from selkies_tpu_torch.pipeline.elements import SyntheticSource

    src = SyntheticSource(W, H, seed=APP_SEED)
    frames = [src.capture() for _ in range(n + 10)]
    enc = create_encoder("tpuh264enc", width=W, height=H, fps=60, device=dev)
    enc.prewarm()
    rc = CbrRateController(bitrate_kbps=APP_KBPS, fps=60)
    for f in frames[:10]:
        for au, st, _ in enc.submit(f, rc.frame_qp()):
            rc.update(len(au), idr=st.idr or st.scene_cut)
    for au, st, _ in enc.flush():
        rc.update(len(au), idr=st.idr or st.scene_cut)
    if dev != "cpu":
        torch.cuda.synchronize()
    t_sub, lat = {}, {}

    def take(outs):
        now = time.perf_counter()
        for au, st, m in outs:
            lat[m] = (now - t_sub[m]) * 1e3
            rc.update(len(au), idr=st.idr or st.scene_cut)
    t0 = time.perf_counter()
    for i, f in enumerate(frames[10:]):
        t_sub[i] = time.perf_counter()
        take(enc.submit(f, rc.frame_qp(), i))
    take(enc.flush())
    wall = time.perf_counter() - t0
    enc.close()
    v = sorted(lat.values())
    return {"frames": n, "fps": n / wall, "submit_to_au_ms_median": statistics.median(v),
            "submit_to_au_ms_p95": v[-(-95 * n // 100) - 1]}


def _app_phase(timing: bool, dev=None) -> dict:
    """Phase 16: (a) the app on the registry row, (b) the ladder, (c) the
    policy engine and the SLO plane, (d) timing (with ``timing``)."""
    import os

    from selkies_tpu_torch.monitoring.telemetry import telemetry

    out = {}
    t0 = time.perf_counter()
    out["a"] = _app_run(dev, "a")
    a = out["a"]
    print(f"phase 16 (a) TorchWebRTCApp(SyntheticSource({W}, {H}), tpuh264enc, 60 fps, "
          f"{APP_KBPS} kbps): {a['sent']} sent, {a['returned']} returned after the stop's flush; "
          f"AUs equal a direct card row's replay and the first {APP_CPU_FRAMES} the CPU's; "
          f"IDR + {W}x{H} SPS first; K1 {a['me_mc_launches']} launches = {a['p_frames']} "
          f"non-static P frames; kinds {a['kinds']}, QPs {a['qps'][0]}-{a['qps'][-1]}; "
          f"served {a['serve_s']:.1f} s, replays {a['card_replay_s']:.1f} s card, "
          f"{a['cpu_replay_s']:.1f} s cpu; memory {a['memory']}")
    out["b"] = _ladder_run(dev)
    b = out["b"]
    print(f"phase 16 (b) ladder {LADDER_SPEC}, recover_after {LADDER_RECOVER}: software rung "
          f"{b['software_rung']} ({b['software_fallback_warning']}); stages [encoder, frames, "
          f"K1, SPS, build ms, build-to-first-AU ms, MiB resident before the build] "
          + json.dumps([[s["encoder"], s["frames"], s["me_mc_launches"], s["sps"],
                         round(s["build_ms"], 1), round(s["first_au_ms"], 1),
                         round(s["memory_before_build"].get("allocated_mb", 0.0), 2)]
                        for s in b["stages"]])
          + f"; every stage's AUs equal its card replay, K1 once per non-static P frame; "
          f"memory at the end {b['memory_end']}; {b['serve_s']:.1f} s")
    saved = {k: os.environ.get(k) for k in ("SELKIES_POLICY", "SELKIES_SLO")}
    os.environ.update({"SELKIES_POLICY": "1", "SELKIES_SLO": "1"})
    try:
        out["c"] = _app_run(dev, "c")
    finally:
        telemetry.disable()
        telemetry.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c = out["c"]
    print(f"phase 16 (c) SELKIES_POLICY=1 SELKIES_SLO=1 over (a)'s trace: {c['sent']} sent by "
          f"{len(c['encoders'])} encoder(s), replays equal; policy "
          + json.dumps({k: c['policy'][k] for k in ("scenario", "frames", "transitions",
                                                     "congested", "disarmed")})
          + "; slo " + json.dumps({k: c['slo'][k] for k in ("scenario", "frames", "evaluations",
                                                           "breaches", "outliers")}))
    out["seconds_checks"] = time.perf_counter() - t0
    if timing:
        card, limit = (s.strip() for s in _nvidia_smi().split(",", 1))
        out["d"] = {"card": card, "power_limit": limit,
                    "app": [_time_app(dev, fr) for fr in (60, 30)],
                    "direct_row": _time_direct_row(dev)}
        print(f"phase 16 (d) the app at {W}x{H} ({card}, {limit}): " + json.dumps(out["d"]))
    return out


# -- phase 17: the fleet's serving core ------------------------------------------

LOOP_N, LOOP_W, LOOP_H = 8, 1920, 1088
LOOP_SMALL = (4, 640, 368)  # phase 9 (b)'s geometry, where the card meets the CPU
LOOP_FPS = 60
LOOP_KBPS = 8000
LOOP_TICKS = 4
# tick -> ops before it: ("key", session) / ("kbps", session, kbps)
LOOP_OPS = {2: [("key", 3), ("kbps", 0, 4000)]}
LOOP_CYCLE = 12  # frames per session the live loop's sources cycle through
LOOP_STEADY_S = 4.0
LOOP_PAIRS = 1  # the script's time budget (ROADMAP) has room for one pair beside phase 20
LOOP_IDLE_S = 1.0
LOOP_PROFILE_TICKS = 5
LOOP_BANDED = (4, 1920, 1080)
LOOP_BANDED_TICKS = 6
LOOP_LADDER = (4, 640, 384)
# 24 encoder raises in a row from the third tick: warn, force-IDR (2),
# restart (6), degrade 1 (12), 2 (18) and 3, the software service (24);
# then LOOP_LADDER_RECOVER healthy ticks reverse one level each
LOOP_LADDER_SPEC = "encoder@3-26:raise"
LOOP_LADDER_RECOVER = 3
LOOP_LADDER_EVENTS = 38


class _RecordingService:
    """Stands in for a fleet service: forwards every attribute; logs each
    call that steers or feeds it (per tick the capture index of the batch
    and the AUs with their IDR flags), counts K1's launches inside its
    ticks and the host ms from its build to its first AUs."""

    CALLS = ("set_qp", "set_bitrate", "force_keyframe", "encode_tick", "dispatch_tick",
             "complete_tick")

    def __init__(self, svc, kw: dict, sources, build_ms: float):
        self.__dict__.update(svc=svc, cls=type(svc).__name__, kw=kw, sources=sources, log=[],
                             launches=0, build_ms=build_ms, t_built=time.perf_counter(),
                             first_au_ms=None)

    def __getattr__(self, attr):
        from selkies_tpu_torch.models.h264 import me_mc

        val = getattr(self.svc, attr)
        if attr not in self.CALLS:
            return val

        def call(*a, **k):
            if attr in ("encode_tick", "dispatch_tick"):
                self.log.append(("tick", len(self.sources[0].captured_at) - 1))
            k0 = me_mc.launches
            out = val(*a, **k)
            if attr in ("encode_tick", "dispatch_tick"):
                self.__dict__["launches"] += me_mc.launches - k0
            if attr in ("encode_tick", "complete_tick"):
                self.log.append(("aus", [hashlib.sha256(au).hexdigest() for au in out],
                                 list(self.svc.last_idrs)))
                if self.first_au_ms is None:
                    self.__dict__["first_au_ms"] = (time.perf_counter() - self.t_built) * 1e3
            elif attr != "dispatch_tick":
                self.log.append((attr, *a))
            return out
        return call

    def ticks(self) -> list:
        """-> [(capture index, AU sha256s, IDR flags)] in order."""
        idx = [e[1] for e in self.log if e[0] == "tick"]
        aus = [e[1:] for e in self.log if e[0] == "aus"]
        return [(i, *a) for i, a in zip(idx, aus)]


def _cycles(n: int, w: int, h: int) -> list:
    """Per session LOOP_CYCLE frames of phase 9's desktop trace (even
    sessions scroll, odd ones type), cut to h rows."""
    bases = _fleet_bases(n, w, h)
    return [[np.ascontiguousarray(_session_frame(bases[i], i, t)) for t in range(LOOP_CYCLE)]
            for i in range(n)]


def _loop_fleet(n: int, w: int, h: int, dev, sources, *, connected: bool = True,
                service=None):
    """SessionFleet over n slots at LOOP_FPS, each slot's WebSocket plane
    phase 16's recording transport, with the given sources (``dev`` None:
    the card through the pool)."""
    import torch

    from selkies_tpu_torch.parallel.fleet import SessionFleet, SessionSlot

    slots = [SessionSlot(k, bitrate_kbps=LOOP_KBPS, fps=LOOP_FPS, ws=_AppTransport())
             for k in range(n)]
    for s in slots:
        s.connected = connected
    devices = None if dev is None else [torch.device(dev)]
    return SessionFleet(slots, width=w, height=h, fps=LOOP_FPS, devices=devices,
                        service=service, sources=sources)


def _sources(frames) -> list:
    """Per session a source cycling through its frames, stamped at each
    capture (phase 16's _StampedSource)."""
    from functools import partial
    from itertools import cycle
    from types import SimpleNamespace

    return [_StampedSource(SimpleNamespace(capture=partial(next, cycle(f)))) for f in frames]


async def _quiesce(fleet) -> None:
    """Disconnect every slot and wait out the tick in flight, so that the
    stop that follows closes an idle service."""
    import asyncio

    for s in fleet.slots:
        s.connected = False
    while fleet._tick_in_flight:
        await asyncio.sleep(0.001)


def _loop_drive(fleet, ticks: int, ops=LOOP_OPS) -> list:
    """Tick the fleet by hand as _run does -> per tick (AU sha256s, IDR
    flags, QPs, K1 launches inside _encode_tick)."""
    from selkies_tpu_torch.models.h264 import me_mc

    out = []
    for t in range(ticks):
        for op in ops.get(t, ()):
            if op[0] == "key":
                fleet.force_keyframe(op[1])
            else:
                fleet.set_session_bitrate(op[1], op[2])
        failed = fleet._capture_batch()
        if failed:
            _fail(f"phase 17: captures failed {failed}")
        k0 = me_mc.launches
        aus, idrs, qps, _ = fleet._encode_tick()
        launched = me_mc.launches - k0
        if not all(au.startswith(b"\x00\x00\x00\x01") for k, au in enumerate(aus)
                   if fleet.session_codec(k) == "h264"):
            _fail(f"phase 17 tick {t}: an H.264 access unit is not Annex-B")
        for slot, au, idr in zip(fleet.slots, aus, idrs):
            if au:
                slot.rc.update(len(au), idr=idr)
        out.append(([hashlib.sha256(au).hexdigest() for au in aus], list(idrs), list(qps),
                    launched))
    return out


def _direct_drive(svc, batches, run, ops=LOOP_OPS, tick=None) -> list:
    """A direct service fed the batches (through ``tick``, default its
    serial encode_tick), each tick's QPs from ``run`` and the ops'
    keyframes -> per tick the AU sha256s."""
    tick = tick or svc.encode_tick
    out = []
    for t, batch in enumerate(batches):
        for op in ops.get(t, ()):
            if op[0] == "key":
                svc.force_keyframe(op[1])
        for k, qp in enumerate(run[t][2]):
            svc.set_qp(k, qp)
        out.append([hashlib.sha256(au).hexdigest() for au in tick(batch)])
    return out


def _cycle_batch(frames):
    """Phase 17's capture i: frame i of each session's cycle."""
    return lambda i: np.stack([f[i % len(f)] for f in frames])


def _feed(svc, log: list, batch, ticks: int | None = None, before=None) -> list:
    """Feed ``svc`` a recorder's calls (the first ``ticks`` ticks), each
    tick's frames ``batch(capture index)``, calling ``before(i, svc)`` ahead
    of tick i and once after the last (i = ticks fed) -> [(capture index,
    AU sha256s, IDR flags, tick ms)]; the tick ms is the host clock around
    the direct service's synchronous encode_tick."""
    out = []
    for ev in log:
        if ev[0] == "tick":
            if ticks is not None and len(out) == ticks:
                break
            if before is not None:
                before(len(out), svc)
            frames = batch(ev[1])
            t0 = time.perf_counter()
            aus = svc.encode_tick(frames)
            ms = (time.perf_counter() - t0) * 1e3
            out.append((ev[1], [hashlib.sha256(au).hexdigest() for au in aus],
                        list(svc.last_idrs), ms))
        elif ev[0] != "aus":
            getattr(svc, ev[0])(*ev[1:])
    if before is not None:
        before(len(out), svc)
    return out


def _replay_service(rec, batch, make, **kw) -> list:
    """:func:`_feed` a fresh service from ``make()`` the recorded calls."""
    svc = make()
    try:
        return _feed(svc, rec.log, batch, **kw)
    finally:
        svc.close()


def _check_replay(rec, replay, label: str) -> None:
    got = rec.ticks()
    if [r[:3] for r in replay] != got:
        bad = [i for i, (a, b) in enumerate(zip(got, replay)) if a != tuple(b[:3])]
        _fail(f"phase 17 {label}: the recorded ticks differ from their replay at {bad[:5]} "
              f"({len(got)} recorded, {len(replay)} replayed)")


def _check_sent(fleet, ticks, label: str) -> None:
    """Every AU a slot's plane received is its session's AU of the
    recorded ticks, in order (a stop may cut the last tick's sends)."""
    for k, s in enumerate(fleet.slots):
        sent = [hashlib.sha256(f.au).hexdigest() for f in s.ws.frames]
        want = [t[1][k] for t in ticks if t[1][k] != hashlib.sha256(b"").hexdigest()]
        if not sent or sent != want[:len(sent)] or len(want) - len(sent) > 1:
            _fail(f"phase 17 {label}: slot {k} sent {len(sent)} AUs that are not its "
                  f"{len(want)} recorded ones")


def _pct(v: list, q: int) -> float:
    v = sorted(v)
    return v[-(-q * len(v) // 100) - 1]


def _live_run(dev, frames, occupancy: str, idle: bool) -> dict:
    """(b): the loop over LOOP_N slots with every slot connected: a warm-up,
    LOOP_STEADY_S of steady state, torch.profiler over LOOP_PROFILE_TICKS
    ticks; with ``idle``, LOOP_IDLE_S with no slot connected first."""
    import asyncio
    import os

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    os.environ["SELKIES_OCCUPANCY"] = occupancy
    n, w, h = LOOP_N, LOOP_W, LOOP_H
    t0 = time.perf_counter()
    svc = TorchMultiSessionH264Service(n, w, h, qp=28, fps=LOOP_FPS, device=dev)
    sources = _sources(frames)
    rec = _RecordingService(svc, {}, sources, (time.perf_counter() - t0) * 1e3)
    gate = _Gate()
    fleet = _loop_fleet(n, w, h, dev, sources, connected=not idle, service=_Gated(
        rec, gate, ("encode_tick", "dispatch_tick", "complete_tick")))
    ticks_at = []
    fleet.on_tick = lambda ms: ticks_at.append((time.perf_counter(), ms))
    win = {}

    async def go():
        await fleet.start()
        try:
            if idle:
                k0 = me_mc.launches
                await asyncio.sleep(LOOP_IDLE_S)
                win["idle"] = {"seconds": LOOP_IDLE_S, "me_mc_launches": me_mc.launches - k0,
                               "service_calls": len(rec.log), "ticks": fleet.ticks,
                               "captures": len(sources[0].captured_at)}
                for s in fleet.slots:
                    s.connected = True
            while fleet.ticks < 10:  # the IDR tick and the first P ticks
                await asyncio.sleep(0.002)
            win["n0"] = [len(s.ws.frames) for s in fleet.slots]
            win["k0"], win["t0"], win["tick0"] = me_mc.launches, time.perf_counter(), fleet.ticks
            await asyncio.sleep(LOOP_STEADY_S)
            win["n1"] = [len(s.ws.frames) for s in fleet.slots]
            win["k1"], win["t1"], win["tick1"] = me_mc.launches, time.perf_counter(), fleet.ticks
            async def ticks(k=fleet.ticks):
                while fleet.ticks < k + LOOP_PROFILE_TICKS:
                    await asyncio.sleep(0.001)
            prof, wall_ms = await _live_profile(gate, ticks)
            win["profile"] = _device_activity(prof, wall_ms)
            win["profile"]["ticks"] = LOOP_PROFILE_TICKS
            await _quiesce(fleet)
        finally:
            await fleet.stop()
    asyncio.run(go())
    if fleet.supervisor.counters["failures"]:
        _fail(f"phase 17 (b): the supervisor counted {fleet.supervisor.counters}")
    if idle and (win["idle"]["me_mc_launches"] or win["idle"]["service_calls"]
                 or win["idle"]["captures"]):
        _fail(f"phase 17 (b): the idle fleet worked: {win['idle']}")
    ticks = rec.ticks()
    _check_sent(fleet, ticks, f"(b) occupancy {occupancy}")
    if rec.launches != sum(1 for t in ticks if not all(t[2])):
        _fail(f"phase 17 (b): K1 launched {rec.launches} times in {len(ticks)} ticks")
    t_rep = time.perf_counter()
    replay = _replay_service(rec, _cycle_batch(frames), lambda: (
        TorchMultiSessionH264Service(n, w, h, qp=28, fps=LOOP_FPS, device=dev)))
    replay_s = time.perf_counter() - t_rep
    _check_replay(rec, replay, f"(b) occupancy {occupancy}")
    secs = win["t1"] - win["t0"]
    delivered = sum(b - a for a, b in zip(win["n0"], win["n1"]))
    lat = []
    for k, s in enumerate(fleet.slots):
        cap = fleet.sources[k].captured_at
        lat += [(s.ws.sent_at[j] - cap[j]) * 1e3 for j in range(win["n0"][k], win["n1"][k])]
    tick_ms = [ms for t, ms in ticks_at if win["t0"] <= t <= win["t1"]]
    direct_p = [r[3] for r in replay if not all(r[2])]
    direct_ms = statistics.median(direct_p)
    fps = delivered / secs
    out = {"occupancy": occupancy, "seconds": secs, "ticks": win["tick1"] - win["tick0"],
           "delivered": delivered, "fps": fps,
           "tick_ms_median": statistics.median(tick_ms), "tick_ms_p95": _pct(tick_ms, 95),
           "capture_to_send_ms_median": statistics.median(lat),
           "capture_to_send_ms_p95": _pct(lat, 95),
           "failures": fleet.supervisor.counters["failures"],
           "me_mc_launches": win["k1"] - win["k0"], "me_mc_launches_run": rec.launches,
           "ticks_run": len(ticks), "profile": win["profile"],
           "direct_p_tick_ms_median": direct_ms, "direct_p_ticks": len(direct_p),
           "share_of_direct": fps / (n * 1e3 / direct_ms), "replay_s": replay_s}
    if idle:
        out["idle"] = win["idle"]
    return out


def _ladder_loop(dev, frames) -> dict:
    """(d): the ladder at LOOP_LADDER under LOOP_LADDER_SPEC with the
    supervisor's clock frozen; every service the fleet builds recorded."""
    import asyncio

    from selkies_tpu_torch.parallel import serving
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
    from selkies_tpu_torch.resilience import faultinject

    n, w, h = LOOP_LADDER
    sources = _sources(frames)
    built = []

    def record(make, kw):
        t0 = time.perf_counter()
        svc = make()
        rec = _RecordingService(svc, kw, sources, (time.perf_counter() - t0) * 1e3)
        built.append(rec)
        return rec

    real_sw = serving.SoftwareFleetService

    def software(*a, **kw):
        return record(lambda: real_sw(*a, **kw), dict(kw, args=a))
    first = record(lambda: TorchMultiSessionH264Service(n, w, h, qp=28, fps=LOOP_FPS,
                                                        device=dev), {})
    fleet = _loop_fleet(n, w, h, dev, sources, service=first)
    make_tpu = fleet._make_tpu_service
    fleet._make_tpu_service = lambda: record(make_tpu, {})
    sup = fleet.supervisor
    sup.clock = lambda: 0.0
    sup.last_ok = 0.0
    sup.recover_after = LOOP_LADDER_RECOVER
    events = []
    for name in ("tick_ok", "failure"):
        real = getattr(sup, name)

        def wrapped(*a, _real=real, _name=name, **k):
            r = _real(*a, **k)
            events.append((_name, sup.rung.name, sup.degrade_level, fleet.fps,
                           fleet.service.cls, len(built)))
            return r
        setattr(sup, name, wrapped)

    async def go():
        await fleet.start()
        t0 = time.perf_counter()
        try:
            while len(events) < LOOP_LADDER_EVENTS:
                if time.perf_counter() - t0 > 300:
                    _fail(f"phase 17 (d): {len(events)} ladder events in 300 s")
                await asyncio.sleep(0.005)
            await _quiesce(fleet)
        finally:
            await fleet.stop()
    faultinject.reset_faults()
    faultinject.configure_faults(LOOP_LADDER_SPEC)
    serving.SoftwareFleetService = software
    t0 = time.perf_counter()
    try:
        asyncio.run(go())
    finally:
        serving.SoftwareFleetService = real_sw
        faultinject.reset_faults()
    serve_s = time.perf_counter() - t0
    events = events[:LOOP_LADDER_EVENTS]
    classes = [r.cls for r in built]
    want = ["TorchMultiSessionH264Service"] * 2 + ["SoftwareFleetService",
                                                   "TorchMultiSessionH264Service"]
    levels = [e[2] for e in events]
    if classes != want or max(levels) != 3 or levels[-1] != 0 or events[-1][3] != LOOP_FPS \
            or {e[3] for e in events} != {LOOP_FPS, LOOP_FPS // 2, LOOP_FPS // 4}:
        _fail(f"phase 17 (d): built {classes}, events {events}")
    stages = []
    for i, rec in enumerate(built):
        ticks = rec.ticks()
        if rec.cls == "SoftwareFleetService":
            a, kw = rec.kw["args"], {k: v for k, v in rec.kw.items() if k != "args"}
            make = (lambda a=a, kw=kw: real_sw(*a, **kw))
            encoders = sorted({type(e).__name__ for e in rec.svc.encoders})
            p = sum(sum(not x for x in t[2]) for t in ticks)
            # without libx264 the rung serves solo tpuh264enc rows: K1 once
            # per P session a tick (the cycle has no static repeat)
            if encoders == ["TorchH264Encoder"] and rec.launches != p:
                _fail(f"phase 17 (d): the software rung launched K1 {rec.launches} times for "
                      f"{p} P session-frames")
        else:
            make = (lambda: TorchMultiSessionH264Service(n, w, h, qp=28, fps=LOOP_FPS,
                                                         device=dev))
            encoders = None
            if rec.launches != sum(1 for t in ticks if not all(t[2])):
                _fail(f"phase 17 (d): service {i} launched K1 {rec.launches} times")
        replay = _replay_service(rec, _cycle_batch(frames), make)
        _check_replay(rec, replay, f"(d) service {i} ({rec.cls})")
        stages.append({"service": rec.cls, "encoders": encoders, "ticks": len(ticks),
                       "me_mc_launches": rec.launches, "build_ms": rec.build_ms,
                       "first_au_ms": rec.first_au_ms,
                       "first_tick_idr": all(ticks[0][2]) if ticks else None})
    ticks = [t for rec in built for t in rec.ticks()]
    _check_sent(fleet, sorted(ticks), "(d)")
    rungs = [e[1] for e in events]
    return {"events": events, "rungs": sorted(set(rungs), key=rungs.index), "stages": stages,
            "counters": dict(sup.counters), "serve_s": serve_s,
            "sent": [len(s.ws.frames) for s in fleet.slots]}


def _fleet_loop_phase(dev=None) -> dict:
    """Phase 17: (a) SessionFleet tick by tick at full width against a
    direct service and the CPU, (b) the live loop, (c) the banded fleet and
    a negotiation, (d) the ladder, (e) dryrun (``dev`` None: the card)."""
    import os

    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.fleet import dryrun
    from selkies_tpu_torch.parallel.occupancy import OccupancyScheduler
    from selkies_tpu_torch.parallel.serving import (
        TorchBandedFleetService,
        TorchMultiSessionH264Service,
    )
    from selkies_tpu_torch.resilience import faultinject, reset_device_pool
    from selkies_tpu_torch.signalling import negotiate

    out: dict = {}
    _set_hooks(False)
    faultinject.reset_faults()
    reset_device_pool()
    saved = {k: os.environ.get(k) for k in ("SELKIES_OCCUPANCY", "SELKIES_BANDS")}
    os.environ.pop("SELKIES_BANDS", None)
    os.environ.pop("SELKIES_OCCUPANCY", None)
    try:
        # (a) full width, tick by tick, against a direct service; the small
        # geometry against the CPU
        t0 = time.perf_counter()
        n, w, h = LOOP_N, LOOP_W, LOOP_H
        bases = _fleet_bases(n, w, h)
        batches = [_fleet_batch(bases, t) for t in range(LOOP_TICKS)]
        fleet = _loop_fleet(n, w, h, dev, _sources([[b[i] for b in batches] for i in range(n)]))
        svc_cls, svc_dev = type(fleet.service).__name__, str(fleet.service.device)
        me_mc.launches = 0
        run = _loop_drive(fleet, LOOP_TICKS)
        a_launches = me_mc.launches
        fleet.service.close()
        if fleet._occ is not None:
            fleet._occ.close()
        direct = TorchMultiSessionH264Service(n, w, h, qp=28, fps=LOOP_FPS, device=dev)
        want = _direct_drive(direct, batches, run)
        direct.close()
        if [r[0] for r in run] != want:
            _fail("phase 17 (a): the fleet's AUs differ from a direct service fed the same "
                  "batches and QPs")
        want_k1 = [0 if all(r[1]) else 1 for r in run]
        if [r[3] for r in run] != want_k1 or svc_cls != "TorchMultiSessionH264Service":
            _fail(f"phase 17 (a): {svc_cls} launched K1 {[r[3] for r in run]} per tick, "
                  f"want {want_k1}")
        sn, sw, sh = LOOP_SMALL
        sbases = _fleet_bases(sn, sw, sh)
        sbatches = [_fleet_batch(sbases, t) for t in range(LOOP_TICKS)]
        small = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            f = _loop_fleet(sn, sw, sh, d, _sources([[b[i] for b in sbatches] for i in range(sn)]))
            small[name] = _loop_drive(f, LOOP_TICKS)
            f.service.close()
            if f._occ is not None:
                f._occ.close()
        if [r[:3] for r in small["card"]] != [r[:3] for r in small["cpu"]]:
            _fail(f"phase 17 (a): {sn} x {sw}x{sh} on the card differs from the CPU fleet")
        out["a"] = {"service": svc_cls, "device": svc_dev, "sha256": [r[0] for r in run],
                    "idrs": [r[1] for r in run], "qps": [r[2] for r in run],
                    "launches_per_tick": [r[3] for r in run], "me_mc_launches": a_launches,
                    "small_sha256": [r[0] for r in small["card"]],
                    "seconds": time.perf_counter() - t0}
        print(f"phase 17 (a) SessionFleet({n} slots, {w}x{h}, {LOOP_FPS} fps, bands 1) -> "
              f"{svc_cls} on {svc_dev}: {LOOP_TICKS} ticks (the IDR tick, a forced keyframe and "
              f"a retune at tick 2) by _capture_batch + _encode_tick equal a direct service fed "
              f"the same batches and the slots' QPs {out['a']['qps'][-1]}; K1 per tick "
              f"{out['a']['launches_per_tick']}; {sn} x {sw}x{sh} equal the CPU fleet; "
              f"{out['a']['seconds']:.1f} s")

        # (b) the live loop, occupancy on / off in turns
        t0 = time.perf_counter()
        frames = _cycles(n, w, h)
        runs = []
        for p in range(LOOP_PAIRS):
            for occ in ("1", "0"):
                runs.append(_live_run(dev, frames, occ, idle=not runs))
        del frames
        card, limit = (s.strip() for s in _nvidia_smi().split(",", 1)) if dev is None \
            else ("cpu", "none")
        keys = ("fps", "tick_ms_median", "tick_ms_p95", "capture_to_send_ms_median",
                "capture_to_send_ms_p95", "direct_p_tick_ms_median", "share_of_direct")
        out["b"] = {"card": card, "power_limit": limit, "runs": runs,
                    "by_occupancy": {occ: {k: [r[k] for r in runs if r["occupancy"] == occ]
                                           for k in keys} for occ in ("1", "0")},
                    "idle": runs[0]["idle"], "seconds": time.perf_counter() - t0}
        print(f"phase 17 (b) the live loop, {n} x {w}x{h} at a {LOOP_FPS} fps tick, "
              f"{LOOP_STEADY_S:.0f} s of steady state x {len(runs)} runs ({card}, {limit}); "
              f"idle {LOOP_IDLE_S:.0f} s: {runs[0]['idle']}; every sent AU equals its direct "
              f"replay; failures 0: " + json.dumps(out["b"]["by_occupancy"])
              + " profile " + json.dumps([{k: r["profile"].get(k) for k in
                                           ("device_ops", "device_idle_share", "wall_ms")}
                                          for r in runs])
              + f"; {out['b']['seconds']:.1f} s")

        # (c) the banded fleet, then a negotiation
        t0 = time.perf_counter()
        os.environ["SELKIES_BANDS"] = "2"
        os.environ["SELKIES_OCCUPANCY"] = "1"
        bn, bw, bh = LOOP_BANDED
        bbases = _fleet_bases(bn, bw, bh)
        bbatches = [_fleet_batch(bbases, t) for t in range(LOOP_BANDED_TICKS + 2)]
        fleet = _loop_fleet(bn, bw, bh, dev,
                            _sources([[b[i] for b in bbatches] for i in range(bn)]))
        bcls = type(fleet.service).__name__
        me_mc.launches = 0
        brun = _loop_drive(fleet, LOOP_BANDED_TICKS)
        c_launches = me_mc.launches
        row = fleet.placer.row(0)
        neg = fleet.negotiate_session(0, ["av1", "h264"])
        expect = negotiate.resolve(["av1", "h264"], session_chips=max(1, len(row)),
                                   per_session_carve=True)
        after = _loop_drive(fleet, 2, ops={})
        codec = fleet.session_codec(0)
        if fleet._occ is not None:
            fleet._occ.close()
        fleet.service.close()
        os.environ.pop("SELKIES_OCCUPANCY", None)
        direct = TorchBandedFleetService(bn, bw, bh, qp=28, fps=LOOP_FPS, bands=2,
                                         devices=None if dev is None else [torch.device(dev)])
        # scheduled, as phase 14 (a) holds equal to the serial tick: the
        # serial 1080p IDR tick takes tens of seconds (PERF.md section 5)
        sched = OccupancyScheduler.for_service(direct)
        bwant = _direct_drive(direct, bbatches, brun + after, tick=sched.encode_tick)
        sched.close()
        direct.close()
        if bcls != "TorchBandedFleetService" or [r[0] for r in brun] != bwant[:len(brun)]:
            _fail(f"phase 17 (c): {bcls}'s AUs differ from a direct banded service's")
        bk1 = [r[3] for r in brun]
        want_bk1 = [2 * sum(1 for i in range(bn) if not r[1][i] and (i, t) not in FLEET_STATIC)
                    for t, r in enumerate(brun)]
        if bk1 != want_bk1:
            _fail(f"phase 17 (c): K1 per tick {bk1}, want {want_bk1}")
        if (neg.codec, neg.reason) != (expect.codec, expect.reason) or codec != neg.codec \
                or not all(r[0][0] != hashlib.sha256(b"").hexdigest() for r in after):
            _fail(f"phase 17 (c): negotiated {neg}, resolve gave {expect}, session codec "
                  f"{codec}")
        if codec == "h264" and [r[0] for r in after] != bwant[len(brun):]:
            _fail("phase 17 (c): the AUs after the negotiation differ from the direct service's")
        out["c"] = {"service": bcls, "sha256": [r[0] for r in brun],
                    "launches_per_tick": bk1, "me_mc_launches": c_launches,
                    "negotiated": {"codec": neg.codec, "reason": neg.reason, "cols": neg.cols,
                                   "av1_available": negotiate.codec_available("av1")},
                    "seconds": time.perf_counter() - t0}
        print(f"phase 17 (c) SELKIES_BANDS=2, {bn} x {bw}x{bh}, occupancy on: {bcls}; "
              f"{LOOP_BANDED_TICKS} ticks equal a direct banded service; K1 per tick {bk1} "
              f"(2 per non-static banded P session); negotiate_session(0, ['av1', 'h264']) -> "
              f"{neg.codec} ({neg.reason}; av1 available: "
              f"{out['c']['negotiated']['av1_available']}) and session 0 keeps serving; "
              f"{out['c']['seconds']:.1f} s")
        os.environ.pop("SELKIES_BANDS", None)

        # (d) the ladder at the small geometry
        t0 = time.perf_counter()
        ln, lw, lh = LOOP_LADDER
        out["d"] = _ladder_loop(dev, _cycles(ln, lw, lh))
        out["d"]["seconds"] = time.perf_counter() - t0
        d = out["d"]
        print(f"phase 17 (d) ladder {LOOP_LADDER_SPEC} at {ln} x {lw}x{lh}, recover_after "
              f"{LOOP_LADDER_RECOVER}, clock frozen: rungs {d['rungs']}; fps "
              f"{sorted({e[3] for e in d['events']}, reverse=True)}; services [class, encoders, "
              f"ticks, K1, build ms, build-to-first-AU ms] "
              + json.dumps([[s["service"], s["encoders"], s["ticks"], s["me_mc_launches"],
                             round(s["build_ms"], 1), round(s["first_au_ms"] or 0.0, 1)]
                            for s in d["stages"]])
              + f"; every service's ticks equal its replay; {d['seconds']:.1f} s")

        # (e) dryrun on the card
        t0 = time.perf_counter()
        me_mc.launches = 0
        dryrun(8, devices=None if dev is None else [torch.device(dev)])
        out["e"] = {"sessions": 8, "me_mc_launches": me_mc.launches,
                    "seconds": time.perf_counter() - t0}
        if dev is None and out["e"]["me_mc_launches"] != 1:
            _fail(f"phase 17 (e): dryrun(8) launched K1 {out['e']['me_mc_launches']} times")
        print(f"phase 17 (e) dryrun(8): 8 sessions of 64x64 on one card, K1 "
              f"{out['e']['me_mc_launches']}; {out['e']['seconds']:.1f} s")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_device_pool()
    return out


# -- phase 18: the solo server ------------------------------------------------------

SERVER_FPS = 60
SERVER_KBPS = 8000
SERVER_RETUNE_KBPS = 6000
SERVER_S = 3.5  # seconds of video the in-process client reads after the first frame
SERVER_PROFILE_TICKS = 10
ENTRY_FRAMES = 30
ENTRY_START_S = 300.0  # process start to /healthz 200
# SIGTERM to exit: the drain, then aiohttp's shutdown timeout, which the
# open WebSocket handlers hold (the reference's behaviour)
ENTRY_EXIT_S = 120.0
SERVER_CMD = [sys.executable, "-m", "selkies_tpu_torch"]
SERVER_EXPORTER_FAMILIES = ("fps", "fps_hist", "gpu_utilization", "latency")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ServerClient:
    """A browser on /media: reads until closed, keeps each video frame with
    the host clock at its arrival, each control message, answers pings."""

    def __init__(self, ws):
        self.ws, self.video, self.texts, self.closed = ws, [], [], False

    async def read(self):
        import aiohttp

        from selkies_tpu_torch.transport.websocket import KIND_VIDEO, parse_media_frame

        async for msg in self.ws:
            if msg.type == aiohttp.WSMsgType.BINARY:
                kind, flags, ts, payload = parse_media_frame(msg.data)
                if kind == KIND_VIDEO:
                    self.video.append((time.perf_counter(), flags, ts, payload))
            elif msg.type == aiohttp.WSMsgType.TEXT:
                obj = json.loads(msg.data)
                self.texts.append(obj)
                if obj["type"] == "ping":
                    await self.ws.send_str(f"pong,{obj['data']['start_time']}")
        self.closed = True


async def _wait_for(cond, timeout_s: float, what: str, phase: str = "18"):
    import asyncio

    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            _fail(f"phase {phase}: {what} within {timeout_s} s")
        await asyncio.sleep(0.01)


def _server_in_process(dev) -> dict:
    """(a): Orchestrator(cfg, device) on the tpuh264enc row at W x H, 60 fps,
    SERVER_KBPS, telemetry and the exporter on; one client over /media."""
    import asyncio
    import os
    import tempfile

    import aiohttp

    from selkies_tpu_torch.config import FLAGS, Config
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.orchestrator import Orchestrator
    from selkies_tpu_torch.transport.websocket import FLAG_KEYFRAME

    tmp = Path(tempfile.mkdtemp(prefix="selkies-phase18-"))
    mport = _free_port()
    values = {fl.name: fl.default for fl in FLAGS}
    values.update(addr="127.0.0.1", port=0, capture_width=W, capture_height=H,
                  framerate=SERVER_FPS, video_bitrate=SERVER_KBPS, encoder="tpuh264enc",
                  enable_metrics_http=True, metrics_http_port=mport,
                  json_config=str(tmp / "selkies_config.json"),
                  rtc_config_json=str(tmp / "rtc.json"), enable_cursors=False)
    saved_display = os.environ.pop("DISPLAY", None)  # the synthetic source
    telemetry.enable()
    built, restore = _record_builds()
    real_me_mc, grab, sends = me_mc.me_mc, {}, []

    def grabbing(*args):
        # one of the session's P frames: its inputs and the kernel's outputs
        out = real_me_mc(*args)
        if grab.get("armed") and "args" not in grab:
            grab["args"] = [a.clone() for a in args]
            grab["out"] = [o.clone() for o in out]
        return out
    out: dict = {}
    try:
        orch = Orchestrator(Config(values=values), device=dev)
        if len(built) != 1 or built[0].name != "tpuh264enc":
            _fail(f"phase 18 (a): the server built {[r.name for r in built]}")
        src = orch.app.source = _StampedSource(orch.app.source)
        gate = _Gate()
        orch.app.encoder = _Gated(orch.app.encoder, gate, ENCODER_CALLS)
        mux_send = orch.transport.send_video

        async def send_video(ef):
            sends.append((ef.timestamp_90k, time.perf_counter()))
            return await mux_send(ef)
        orch.transport.send_video = send_video
        me_mc.me_mc = grabbing

        async def go():
            task = asyncio.ensure_future(orch.run())
            await _wait_for(lambda: orch.server._runner is not None
                            and orch.server._runner.addresses, 60, "the server listening")
            base = f"http://127.0.0.1:{orch.server.bound_port}"
            async with aiohttp.ClientSession() as http:
                r = await http.get(base + "/healthz")
                out["healthz_before"] = r.status
                ws = await http.ws_connect(base + "/media")
                c = _ServerClient(ws)
                reader = asyncio.ensure_future(c.read())
                await _wait_for(lambda: c.video, 120, "a first video frame")
                t_first = c.video[0][0]
                await _wait_for(lambda: time.perf_counter() - t_first > 1.0, 5, "")
                grab["armed"] = True
                for msg in ("kd,65", "ku,65", "m,10,20,1,0", "m,10,20,0,0",
                            f"vb,{SERVER_RETUNE_KBPS}"):
                    await ws.send_str(msg)
                await _wait_for(lambda: any(
                    t["type"] == "system"
                    and t["data"]["action"] == f"video_bitrate,{SERVER_RETUNE_KBPS}"
                    for t in c.texts), 10, "the bitrate retune's system message")
                pipe = orch.app.pipeline
                # the steady window: from 2 s after the first frame to SERVER_S
                await _wait_for(lambda: time.perf_counter() - t_first > 2.0, 5, "")
                n0, t0 = len(c.video), time.perf_counter()
                d0 = (pipe.dropped_ticks, pipe.dropped_frames, pipe.frames)
                await _wait_for(lambda: time.perf_counter() - t_first > SERVER_S, 30, "")
                n1, t1 = len(c.video), time.perf_counter()
                d1 = (pipe.dropped_ticks, pipe.dropped_frames, pipe.frames)
                prof, wall_ms = await _live_profile(
                    gate, lambda: asyncio.sleep(SERVER_PROFILE_TICKS / SERVER_FPS))
                out["profile"] = dict(_device_activity(prof, wall_ms), ticks=SERVER_PROFILE_TICKS)
                out["window"] = {"frames": n1 - n0, "seconds": t1 - t0,
                                 "fps": (n1 - n0) / (t1 - t0),
                                 "dropped_ticks": d1[0] - d0[0], "dropped_captures": d1[1] - d0[1],
                                 "encoded": d1[2] - d0[2], "t": (t0, t1)}
                r = await http.get(base + "/healthz")
                out["healthz"] = (r.status, json.loads(await r.text())["status"])
                r = await http.get(base + "/statz")
                statz = json.loads(await r.text())
                out["statz"] = (r.status, sorted(statz), sorted(statz.get("histograms", {})))
                r = await http.get(f"http://127.0.0.1:{mport}/metrics")
                text = await r.text()
                names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
                         if line and not line.startswith("#")}
                out["exporter"] = (r.status, sorted(n for n in names if n.startswith("selkies_")),
                                   [f for f in SERVER_EXPORTER_FAMILIES
                                    if f in names or f + "_bucket" in names])
                await ws.close()
                await asyncio.wait_for(reader, 30)
            await _wait_for(lambda: orch.app.pipeline is None or not orch.app.pipeline.running,
                            30, "the session's stop")
            for t in orch._tasks:  # the in-process signalling client's /ws
                if t.get_coro().__name__ == "_signalling_loop":
                    t.cancel()
            await orch.server.stop()
            await asyncio.wait_for(task, 60)
            return c
        c = asyncio.run(go())
    finally:
        me_mc.me_mc = real_me_mc
        restore()
        telemetry.disable()
        telemetry.reset()
        if saved_display is not None:
            os.environ["DISPLAY"] = saved_display
    rec = built[0]
    rec.flush()
    launches = rec.launches  # read before the comparison launch below
    outs = rec.outputs()
    sent = [payload for _, _, _, payload in c.video]
    if [au for au, _, _ in outs][:len(sent)] != sent:
        _fail("phase 18 (a): the received AUs are not the head of what the encoder returned")
    first = c.video[0]
    if not first[1] & FLAG_KEYFRAME or not first[3].startswith(b"\x00\x00\x00\x01\x67") \
            or _sps_size(first[3]) != (W, H):
        _fail(f"phase 18 (a): the first frame is not a keyframe with a {W}x{H} SPS")
    p = _p_count(outs)
    p_sent = _p_count(outs[:len(sent)])
    if launches != p or p == 0:
        _fail(f"phase 18 (a): K1 launched {launches} times for {p} non-static P frames")
    t0 = time.perf_counter()
    if _replay(rec, device=rec.kw["device"]) != _shas(rec):
        _fail("phase 18 (a): the server's AUs differ from a direct card row's replay")
    replay_s = time.perf_counter() - t0
    if "args" not in grab:
        _fail("phase 18 (a): no K1 launch after the warm-up to hold against its plain version")
    plain = me_mc.me_mc_plain(*grab["args"])
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(grab["out"], plain))
    if err:
        _fail(f"phase 18 (a): K1 differs from its plain version on a session P frame by {err}")
    events = orch.input.backend.events
    if type(orch.input.backend).__name__ != "FakeBackend" or not {
            ("key", 65, True), ("key", 65, False), ("pos", 10, 20), ("button", 1, True),
            ("button", 1, False)} <= set(events):
        _fail(f"phase 18 (a): the input backend got {events}")
    overlay = json.loads((tmp / "selkies_config.json").read_text())
    if orch.app.video_bitrate_kbps != SERVER_RETUNE_KBPS or \
            orch.app.rc.bitrate_kbps != SERVER_RETUNE_KBPS or \
            overlay.get("video_bitrate") != SERVER_RETUNE_KBPS:
        _fail(f"phase 18 (a): the bitrate retune did not land (app "
              f"{orch.app.video_bitrate_kbps}, rc {orch.app.rc.bitrate_kbps}, overlay {overlay})")
    if out["healthz_before"] != 200 or out["healthz"] != (200, "ok") or out["statz"][0] != 200 \
            or "histograms" not in out["statz"][1]:
        _fail(f"phase 18 (a): /healthz {out['healthz']}, /statz {out['statz']}")
    ex_status, ex_selkies, ex_parity = out["exporter"]
    if ex_status != 200 or not ex_selkies or list(ex_parity) != list(SERVER_EXPORTER_FAMILIES):
        _fail(f"phase 18 (a): the exporter served {out['exporter']}")
    types = {t["type"] for t in c.texts}
    want_types = {"codec", "system", "ping", "system_stats", "latency_measurement"}
    if dev != "cpu":
        want_types.add("gpu_stats")  # the device monitor, on the card only
    if not want_types <= types:
        _fail(f"phase 18 (a): control messages {sorted(types)}, want {sorted(want_types)}")
    # capture -> send on the host clock: the i-th submit is the i-th capture
    submits = [a[2] for attr, a, _, _ in rec.log if attr == "submit"]
    if len(submits) > len(src.captured_at):
        _fail("phase 18 (a): more submits than captures")
    cap_at = dict(zip(submits, src.captured_at))
    w0, w1 = out["window"].pop("t")
    lat = sorted((t - cap_at[ts]) * 1e3 for ts, t in sends if w0 <= t <= w1 and ts in cap_at)
    n = len(lat)
    out["window"].update(capture_to_send_ms_median=statistics.median(lat),
                         capture_to_send_ms_p95=lat[-(-95 * n // 100) - 1])
    out.update(sent=len(sent), returned=len(outs), p_frames=p, p_frames_sent=p_sent,
               me_mc_launches=launches, prewarm_launches=rec.prewarm_launches,
               me_mc_plain_max_abs_err=err, me_mc_checked_shape=list(grab["args"][1].shape),
               card_replay_s=replay_s, overlay=overlay, input_events=len(events), control_types=sorted(types),
               idrs=sum(1 for _, st, _ in outs if st.idr),
               bytes=sum(len(au) for au in sent))
    rec.log.clear()
    return out


def _server_entry_point() -> dict:
    """(b): ``python3 -m selkies_tpu_torch`` as a user starts it: /healthz,
    ENTRY_FRAMES frames over /media, then SIGTERM through the drain."""
    import asyncio
    import os
    import signal
    import tempfile

    import aiohttp

    from selkies_tpu_torch.transport.websocket import FLAG_KEYFRAME

    tmp = Path(tempfile.mkdtemp(prefix="selkies-phase18-"))
    port = _free_port()
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log_path = out_dir / "phase18_server.log"
    env = {k: v for k, v in os.environ.items() if k != "DISPLAY"}
    cmd = SERVER_CMD + ["--addr", "127.0.0.1", "--port", str(port), "--capture_width", str(W),
                        "--capture_height", str(H), "--json_config", str(tmp / "c.json")]
    out: dict = {"cmd": " ".join(cmd[1:])}
    with open(log_path, "w") as log:
        t_start = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=Path(__file__).resolve().parent)
        try:
            async def go():
                base = f"http://127.0.0.1:{port}"
                async with aiohttp.ClientSession() as http:
                    while True:
                        if proc.poll() is not None:
                            _fail(f"phase 18 (b): the server exited {proc.returncode} before "
                                  f"/healthz answered (log: {log_path})")
                        if time.perf_counter() - t_start > ENTRY_START_S:
                            _fail(f"phase 18 (b): no /healthz within {ENTRY_START_S} s")
                        try:
                            r = await http.get(base + "/healthz")
                            if r.status == 200:
                                break
                        except aiohttp.ClientError:
                            pass
                        await asyncio.sleep(0.1)
                    out["healthz_s"] = time.perf_counter() - t_start
                    ws = await http.ws_connect(base + "/media")
                    c = _ServerClient(ws)
                    reader = asyncio.ensure_future(c.read())
                    await _wait_for(lambda: len(c.video) >= ENTRY_FRAMES, 300,
                                    f"{ENTRY_FRAMES} video frames from the entry point")
                    out["first_au_s"] = c.video[0][0] - t_start
                    n0 = len(c.video)
                    t_term = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
                    health = []
                    while proc.poll() is None and time.perf_counter() - t_term < ENTRY_EXIT_S:
                        try:
                            r = await http.get(base + "/healthz")
                            health.append((r.status, json.loads(await r.text())["status"]))
                        except (aiohttp.ClientError, ValueError):
                            health.append(None)
                        await asyncio.sleep(0.05)
                        if c.closed and health[-1] is None:
                            break
                    await asyncio.wait_for(reader, ENTRY_EXIT_S)
                    return c, n0, t_term, health
            c, n0, t_term, health = asyncio.run(go())
            try:
                rc = proc.wait(timeout=ENTRY_EXIT_S)
            except subprocess.TimeoutExpired:
                _fail(f"phase 18 (b): no exit within {ENTRY_EXIT_S} s of SIGTERM "
                      f"(log: {log_path})")
            out["sigterm_to_exit_s"] = time.perf_counter() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    first = c.video[0]
    if not first[1] & FLAG_KEYFRAME or _sps_size(first[3]) != (W, H):
        _fail("phase 18 (b): the entry point's first frame is not a keyframe with its SPS")
    statuses = [h for h in health if h is not None]
    draining = [h for h in statuses if h == (503, "draining")]
    idr_after = sum(1 for _, flags, _, _ in c.video[n0:] if flags & FLAG_KEYFRAME)
    if rc != 0 or not draining or not idr_after:
        tail = log_path.read_text()[-3000:]
        _fail(f"phase 18 (b): exit {rc}, /healthz after SIGTERM {sorted(set(statuses))}, "
              f"{idr_after} IDRs after it; log tail:\n{tail}")
    out.update(rc=rc, frames=len(c.video), frames_after_sigterm=len(c.video) - n0,
               idrs_after_sigterm=idr_after, healthz_after_sigterm=sorted(set(statuses)),
               draining_polls=len(draining), log=str(log_path.relative_to(out_dir.parent)))
    return out


def _server_phase(dev=None) -> dict:
    """Phase 18: (a) the solo server in process, (b) the entry point
    (``dev`` None: the card)."""
    out = {"a": _server_in_process("cuda" if dev is None else dev)}
    a = out["a"]
    card, limit = (s.strip() for s in _nvidia_smi().split(",", 1))
    out["card"], out["power_limit"] = card, limit
    print(f"phase 18 (a) Orchestrator(device={dev or 'cuda'}) tpuh264enc {W}x{H} {SERVER_FPS} fps "
          f"{SERVER_KBPS} kbps, one /media client: {a['sent']} frames received, "
          f"{a['returned']} returned after the stop's flush; first a keyframe with its SPS; "
          f"AUs equal a direct card row's replay ({a['card_replay_s']:.1f} s); K1 "
          f"{a['me_mc_launches']} launches = {a['p_frames']} non-static P frames "
          f"({a['p_frames_sent']} of them sent), max |K1 - plain| {a['me_mc_plain_max_abs_err']} "
          f"on a session P frame; input reached the FakeBackend; vb,{SERVER_RETUNE_KBPS} "
          f"retuned the row and the overlay; /healthz {a['healthz']}, /statz 200, exporter "
          f"{len(a['exporter'][1])} selkies_ families + {a['exporter'][2]}; "
          f"({card}, {limit}) " + json.dumps({"window": a["window"], "profile": a["profile"]}))
    out["b"] = _server_entry_point()
    b = out["b"]
    print(f"phase 18 (b) python3 -m selkies_tpu_torch {W}x{H}: /healthz after "
          f"{b['healthz_s']:.2f} s, first AU {b['first_au_s']:.2f} s after the process start; "
          f"{b['frames']} frames; SIGTERM -> /healthz {b['healthz_after_sigterm']}, "
          f"{b['idrs_after_sigterm']} IDR(s) after it, exit {b['rc']} in "
          f"{b['sigterm_to_exit_s']:.2f} s (limit {ENTRY_EXIT_S:.0f} s) ({card}, {limit})")
    return out


# -- phase 19: the solo server over WebRTC ---------------------------------------------

RTC_S = 5.0  # seconds the first browser reads after its first AU (window from 2 s)
RTC_LOSS = "net:loss@p:0.02,seed:3:drop"
RTC_LOSSY_S = 3.0  # seconds of video the second browser reads over the lossy link
RTC_POLL_S = 0.01  # the browser's receiver timers (NACK, freeze)
RTC_TWCC_MS = 100.0  # transport-wide-cc feedback period
RTC_RR_MS = 500.0  # receiver report period
RTC_REPLAY_WINDOW = 1024  # libwebrtc's SRTP replay window, in packets
RTC_INPUT = ("kd,65", "ku,65", "m,10,20,1,0", "m,10,20,0,0")


def _twcc_feedback(sender: int, media: int, arrivals: dict, count: int) -> bytes:
    """Transport-wide-cc feedback (draft-holmer-rmcat-transport-wide-cc-
    extensions-01 section 3.1) for {transport seq: arrival ms}: two-bit
    status vectors, every received packet a large (16-bit) delta."""
    import struct

    seqs = sorted(arrivals, key=lambda s: (s - min(arrivals) + 0x8000) & 0xFFFF)
    base = seqs[0]
    n = ((seqs[-1] - base) & 0xFFFF) + 1
    ref = int(arrivals[base] // 64)
    prev, syms, deltas = ref * 64.0, [], b""
    for i in range(n):
        t = arrivals.get((base + i) & 0xFFFF)
        if t is None:
            syms.append(0)
            continue
        d = max(-32768, min(32767, round((t - prev) * 4)))
        syms.append(2)
        deltas += struct.pack("!h", d)
        prev += d / 4
    chunks = b""
    for i in range(0, n, 7):
        c = 0xC000
        for j, sym in enumerate(syms[i:i + 7]):
            c |= sym << (12 - 2 * j)
        chunks += struct.pack("!H", c)
    body = (struct.pack("!IIHH", sender, media, base, n) + (ref & 0xFFFFFF).to_bytes(3, "big")
            + bytes([count & 0xFF]) + chunks + deltas)
    body += b"\x00" * (-len(body) % 4)
    return struct.pack("!BBH", 0x80 | 15, 205, len(body) // 4) + body


class RtcBrowser:
    """A browser on the WebRTC plane, built from the port's own primitives
    in the pattern of JAX's FakeBrowser (tests/test_webrtc_peer.py): an
    ``IceAgent``, a ``DtlsEndpoint(is_server=False)`` pinned to the offer's
    fingerprint, SRTP from ``session_pair`` (with libwebrtc's 1024-packet
    replay window), an SCTP client association, ``RecoveringReceiver`` as
    its jitter buffer and the codec's depayloader. ``feedback()`` runs the
    receiver's timers and sends its NACKs, transport-wide-cc feedback and
    receiver reports as SRTCP. Every AU the receiver delivers complete is
    kept in ``aus`` as (host clock at its completion, RTP timestamp,
    bytes); a datagram the SRTP layer refuses (a retransmission of a
    packet that already arrived) in ``refused`` as (seq, datagram)."""

    SSRC = 0x42524F57

    def __init__(self, depayloader=None):
        from selkies_tpu_torch.transport.receiver import RecoveringReceiver
        from selkies_tpu_torch.transport.rtp import H264Depayloader
        from selkies_tpu_torch.transport.webrtc.dtls import make_certificate
        from selkies_tpu_torch.transport.webrtc.ice import IceAgent
        from selkies_tpu_torch.transport.webrtc.sctp import SctpAssociation

        browser = self

        class Jitter(RecoveringReceiver):
            def _ingest(self, pkt, wire, now_ms, *, rebuilt):
                if pkt.sequence not in self._wire:
                    browser._media_in(pkt)
                super()._ingest(pkt, wire, now_ms, rebuilt=rebuilt)

            def _close_frame(self):
                ts, poisoned = self._frame_ts, self._frame_poisoned
                super()._close_frame()
                browser._frame_closed(ts, poisoned)

        self.t0 = time.perf_counter()
        self.ice = IceAgent()
        self.ice.on_data = self._on_data
        self.cert, self.key, self.fingerprint = make_certificate()
        self.dtls = self.srtp = self.remote = self.input = None
        self.sctp = SctpAssociation(is_client=True)
        self.sctp.on_message = self._on_dc
        self.receiver = Jitter()
        self.depayloader = depayloader or H264Depayloader
        self.aus, self.refused, self.raw, self.dc_texts = [], [], {}, []
        self.rtcp_in, self.nacked, self.frames = [], [], {}
        self.media_ssrc = self.t_dtls = None
        self.audio_packets = self.received = self.cycles = 0
        self.max_seq = self.base_seq = None
        self.twcc, self.twcc_count, self.prior = {}, 0, (0, 0)
        self.closed = False

    def now_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    # -- negotiation, as FakeBrowser.answer, with RED and ULPFEC accepted
    async def answer(self, offer: str, codec: str = "H264") -> str:
        from selkies_tpu_torch.transport.webrtc import sdp
        from selkies_tpu_torch.transport.webrtc.dtls import DtlsEndpoint

        self.remote = sdp.parse_answer(offer)
        self.dtls = DtlsEndpoint(is_server=False, cert_der=self.cert, key_der=self.key,
                                 peer_fingerprint=self.remote.fingerprint)
        await self.ice.gather()
        self.ice.set_remote(self.remote.ice_ufrag, self.remote.ice_pwd)
        for cand in self.remote.candidates:
            self.ice.add_remote_candidate(cand)
        v, red, fec = sdp.VIDEO_PT, sdp.RED_PT, sdp.ULPFEC_PT
        return (
            "v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
            "a=group:BUNDLE video0 audio0 application0\r\n"
            f"m=video 9 UDP/TLS/RTP/SAVPF {v} {red} {fec}\r\n"
            "a=mid:video0\r\na=recvonly\r\na=rtcp-mux\r\n"
            f"a=ice-ufrag:{self.ice.local_ufrag}\r\na=ice-pwd:{self.ice.local_pwd}\r\n"
            f"a=fingerprint:sha-256 {self.fingerprint}\r\na=setup:active\r\n"
            f"a=rtpmap:{v} {codec}/90000\r\n"
            f"a=rtpmap:{red} red/90000\r\na=rtpmap:{fec} ulpfec/90000\r\n"
            f"a=extmap:{sdp.TWCC_EXT_ID} {sdp.TWCC_URI}\r\n"
            f"a=extmap:{sdp.PLAYOUT_DELAY_EXT_ID} {sdp.PLAYOUT_DELAY_URI}\r\n"
            f"m=audio 9 UDP/TLS/RTP/SAVPF {sdp.AUDIO_PT}\r\n"
            f"a=mid:audio0\r\na=recvonly\r\na=rtpmap:{sdp.AUDIO_PT} OPUS/48000/2\r\n"
            "m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\n"
            "a=mid:application0\r\na=sctp-port:5000\r\n")

    def host_candidate(self) -> str:
        """Our host candidate as 127.0.0.1, as JAX's SignallingPump trickles it."""
        cand = self.ice.local_candidates[0]
        return f"candidate:1 1 udp {cand.priority} 127.0.0.1 {cand.port} typ host"

    def start_dtls(self) -> None:
        self.dtls.handshake_step()
        self._flush()

    def _flush(self) -> None:
        for pkt in self.sctp.take_packets() if self.srtp is not None else ():
            self.dtls.send(pkt)
        for dg in self.dtls.take_datagrams():
            self.ice.send(dg)

    # -- the data channel
    def open_input(self):
        self.input = self.sctp.open_channel("input")
        self._flush()
        return self.input

    def send_text(self, text: str) -> None:
        self.sctp.send(self.input, text.encode())
        self._flush()

    def _on_dc(self, ch, data: bytes, binary: bool) -> None:
        if binary:
            return
        text = data.decode()
        self.dc_texts.append((ch.label, text))
        try:
            obj = json.loads(text)
        except ValueError:
            return
        if isinstance(obj, dict) and obj.get("type") == "ping" and self.input is not None:
            self.send_text(f"pong,{obj['data']['start_time']}")

    # -- the wire in
    def _on_data(self, data: bytes) -> None:
        import struct

        from selkies_tpu_torch.transport.webrtc import rtcp
        from selkies_tpu_torch.transport.webrtc.dtls import is_dtls
        from selkies_tpu_torch.transport.webrtc.srtp import SrtpError, session_pair

        if is_dtls(data):
            self.dtls.put_datagram(data)
            if not self.dtls.handshake_complete:
                if self.dtls.handshake_step():
                    self.t_dtls = time.perf_counter()
                    self.srtp = session_pair(self.dtls.srtp_keys, dtls_is_client=True)
                    self.srtp._rx_replay = _WideReplay()
                    self.sctp.connect()
            else:
                for msg in self.dtls.recv():
                    self.sctp.put_packet(msg)
            self._flush()
        elif self.srtp is not None:
            if rtcp.is_rtcp(data):
                try:
                    self.rtcp_in.append(self.srtp.unprotect_rtcp(data))
                except SrtpError:
                    pass
                return
            seq = struct.unpack_from("!H", data, 2)[0]
            try:
                plain = self.srtp.unprotect(data)
            except SrtpError:
                self.refused.append((seq, data))
                return
            self._on_rtp(plain, seq, data)

    def _on_rtp(self, plain: bytes, seq: int, data: bytes) -> None:
        import struct

        from selkies_tpu_torch.transport.webrtc import sdp

        if plain[1] & 0x7F not in (sdp.VIDEO_PT, sdp.RED_PT, sdp.ULPFEC_PT):
            self.audio_packets += 1
            return
        now = self.now_ms()
        self.raw[seq] = data
        self.media_ssrc = struct.unpack_from("!I", plain, 8)[0]
        self.received += 1
        if self.max_seq is None:
            self.base_seq = self.max_seq = seq
        elif 0 < (seq - self.max_seq) & 0xFFFF < 0x8000:
            self.cycles += seq < self.max_seq
            self.max_seq = seq
        if plain[0] & 0x10:  # the one-byte header extensions: the transport seq
            off = 12 + 4 * (plain[0] & 0x0F)
            end = off + 4 + 4 * struct.unpack_from("!H", plain, off + 2)[0]
            off += 4
            while off < end:
                if plain[off] == 0:
                    off += 1
                    continue
                eid, n = plain[off] >> 4, (plain[off] & 0x0F) + 1
                if eid == sdp.TWCC_EXT_ID:
                    self.twcc[struct.unpack_from("!H", plain, off + 1)[0]] = now
                off += 1 + n
        self.receiver.receive(plain, now)

    def _media_in(self, pkt) -> None:
        """A media packet (RED unwrapped) enters the jitter buffer."""
        from selkies_tpu_torch.transport.webrtc import fec, sdp

        if pkt.payload_type == sdp.RED_PT:
            block_pt, inner = fec.red_unwrap(pkt.payload)
            if block_pt == sdp.ULPFEC_PT:
                return
            pkt.payload_type, pkt.payload = block_pt, inner
        self.frames.setdefault(pkt.timestamp, {})[pkt.sequence] = pkt

    def _frame_closed(self, ts, poisoned: bool) -> None:
        pkts = self.frames.pop(ts, {})
        if ts is None or poisoned or not pkts:
            return
        s0 = next(iter(pkts))
        depay, au = self.depayloader(), None
        for s in sorted(pkts, key=lambda s: (s - s0 + 0x8000) & 0xFFFF):
            au = depay.push(pkts[s]) or au
        if au:
            self.aus.append((time.perf_counter(), ts, au))

    # -- RTCP out
    def send_rtcp(self, plain: bytes) -> None:
        self.ice.send(self.srtp.protect_rtcp(plain))

    def send_pli(self) -> None:
        import struct

        self.send_rtcp(struct.pack("!BBHII", 0x81, 206, 2, self.SSRC, self.media_ssrc))

    def send_nack(self, seqs) -> None:
        from selkies_tpu_torch.transport.webrtc import rtcp

        self.nacked += list(seqs)
        self.send_rtcp(rtcp.build_nack(self.SSRC, self.media_ssrc, list(seqs)))

    def receiver_report(self) -> bytes:
        import struct

        ext = (self.cycles << 16) | self.max_seq
        expected = ext - self.base_seq + 1
        exp_int, rec_int = expected - self.prior[0], self.received - self.prior[1]
        self.prior = (expected, self.received)
        lost = exp_int - rec_int
        frac = (lost << 8) // exp_int if exp_int > 0 and lost > 0 else 0
        cum = max(0, expected - self.received) & 0xFFFFFF
        return struct.pack("!BBHIIIIIII", 0x81, 201, 7, self.SSRC, self.media_ssrc,
                           (min(frac, 255) << 24) | cum, ext, 0, 0, 0)

    def bye(self) -> None:
        import struct

        self.send_rtcp(struct.pack("!BBHI", 0x81, 203, 1, self.SSRC))

    async def feedback(self) -> None:
        """The receiver's timers every RTC_POLL_S: its NACKs, TWCC feedback
        every RTC_TWCC_MS and a receiver report every RTC_RR_MS; the SCTP and
        DTLS retransmission timers every 200 ms."""
        import asyncio

        last_twcc = last_rr = last_tick = 0.0
        while not self.closed:
            await asyncio.sleep(RTC_POLL_S)
            now = self.now_ms()
            if now - last_tick >= 200:
                last_tick = now
                if self.dtls is not None and not self.dtls.handshake_complete:
                    self.dtls.handle_timeout()
                self.sctp.tick()
                if self.dtls is not None:
                    self._flush()
            if self.srtp is None or self.media_ssrc is None:
                continue
            nacks = self.receiver.poll(now)
            if nacks:
                self.send_nack(nacks)
            if self.twcc and now - last_twcc >= RTC_TWCC_MS:
                last_twcc, arrivals, self.twcc = now, self.twcc, {}
                self.twcc_count += 1
                self.send_rtcp(_twcc_feedback(self.SSRC, self.media_ssrc, arrivals,
                                              self.twcc_count))
            if now - last_rr >= RTC_RR_MS:
                last_rr = now
                self.send_rtcp(self.receiver_report())

    def close(self) -> None:
        self.closed = True
        self.ice.close()


class _WideReplay(dict):
    """The browser's SRTP replay windows, RTC_REPLAY_WINDOW packets deep as
    libwebrtc's (the stack's own 64 would refuse a retransmission that
    arrives after a keyframe's burst has moved past it)."""

    def setdefault(self, key, default=None):
        if key not in self:
            from selkies_tpu_torch.transport.webrtc.srtp import ReplayWindow

            self[key] = ReplayWindow()
            self[key].SIZE = RTC_REPLAY_WINDOW
        return self[key]


def _is_idr(au: bytes) -> bool:
    return any(n and n[0] & 0x1F == 5 for n in au.split(b"\x00\x00\x00\x01"))


async def _rtc_connect(http, base: str, b: RtcBrowser, peer: int = 1) -> tuple:
    """The browser's choreography on /ws: HELLO ``peer``, the server's offer
    answered with 127.0.0.1 trickled back, ICE, DTLS, the input channel
    -> (socket, signalling task, feedback task, host clock at each step)."""
    import asyncio

    import aiohttp

    ws = await http.ws_connect(base + "/ws")
    t = {"hello": time.perf_counter()}
    await ws.send_str(f"HELLO {peer}")

    async def signalling():
        async for msg in ws:
            if msg.type != aiohttp.WSMsgType.TEXT or msg.data == "HELLO" \
                    or msg.data.startswith("SESSION_OK"):
                continue
            obj = json.loads(msg.data)
            if "sdp" in obj and obj["sdp"]["type"] == "offer":
                t["offer"] = time.perf_counter()
                answer = await b.answer(obj["sdp"]["sdp"])
                await ws.send_str(json.dumps({"sdp": {"type": "answer", "sdp": answer}}))
                await ws.send_str(json.dumps(
                    {"ice": {"candidate": b.host_candidate(), "sdpMLineIndex": 0}}))
            elif "ice" in obj and b.remote is not None:
                b.ice.add_remote_candidate(obj["ice"]["candidate"])
    sig = asyncio.ensure_future(signalling())
    fb = asyncio.ensure_future(b.feedback())
    await _wait_for(lambda: b.remote is not None, 60, "an offer", phase="19")
    await b.ice.wait_connected(30)
    t["ice"] = time.perf_counter()
    b.start_dtls()
    await _wait_for(lambda: b.t_dtls is not None, 30, "the DTLS handshake", phase="19")
    t["dtls"] = b.t_dtls
    b.open_input()
    await _wait_for(lambda: b.input.open, 10, "the input channel open", phase="19")
    t["input"] = time.perf_counter()
    return ws, sig, fb, t


async def _rtc_leave(ws, sig, fb, b: RtcBrowser) -> None:
    """The browser leaves: an RTCP BYE, then its /ws closes."""
    import asyncio

    b.bye()
    await asyncio.sleep(0.05)
    await ws.close()
    b.close()
    for task in (sig, fb):
        task.cancel()
    await asyncio.gather(sig, fb, return_exceptions=True)


def _rtc_times(t: dict) -> dict:
    return {"hello_to_offer_s": t["offer"] - t["hello"], "offer_to_ice_s": t["ice"] - t["offer"],
            "offer_to_dtls_s": t["dtls"] - t["offer"], "dtls_to_input_s": t["input"] - t["dtls"]}


def _webrtc_server(dev) -> dict:
    """Phase 19: Orchestrator(cfg, device) on the tpuh264enc row at W x H,
    SERVER_FPS, SERVER_KBPS, GCC and telemetry on; (a) RtcBrowser over a
    clean loopback link, (b) a second RtcBrowser under RTC_LOSS."""
    import asyncio
    import os
    import socket
    import tempfile

    import aiohttp

    from selkies_tpu_torch.config import FLAGS, Config
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.orchestrator import Orchestrator
    from selkies_tpu_torch.resilience import configure_faults, get_injector, reset_faults
    from selkies_tpu_torch.transport.webrtc.ice import IceAgent
    from selkies_tpu_torch.transport.webrtc.peer import PeerConnection

    tmp = Path(tempfile.mkdtemp(prefix="selkies-phase19-"))
    # a STUN server on the loopback that never answers: srflx gathering
    # fails as it does for the config's default server on a machine with
    # no network, and no outside host is contacted
    silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silent.bind(("127.0.0.1", 0))
    (tmp / "rtc.json").write_text(json.dumps({"iceServers": [
        {"urls": [f"stun:127.0.0.1:{silent.getsockname()[1]}"]}]}))
    values = {fl.name: fl.default for fl in FLAGS}
    values.update(addr="127.0.0.1", port=0, capture_width=W, capture_height=H,
                  framerate=SERVER_FPS, video_bitrate=SERVER_KBPS, encoder="tpuh264enc",
                  congestion_control=True, json_config=str(tmp / "selkies_config.json"),
                  rtc_config_json=str(tmp / "rtc.json"), enable_cursors=False)
    saved_display = os.environ.pop("DISPLAY", None)  # the synthetic source
    telemetry.enable()
    built, restore = _record_builds()
    real_me_mc, real_send_rtp, grab, sent = me_mc.me_mc, PeerConnection._send_rtp, {}, []
    real_gather, gathers = IceAgent.gather, []

    async def gather(agent):
        # the server's gathering, its STUN request included: what the offer waits for
        t0 = time.perf_counter()
        await real_gather(agent)
        if agent.stun_server is not None:
            gathers.append(time.perf_counter() - t0)

    def grabbing(*args):
        out = real_me_mc(*args)
        if grab.get("armed") and "args" not in grab:
            grab["args"] = [a.clone() for a in args]
            grab["out"] = [o.clone() for o in out]
        return out

    def send_rtp(pc, pkt, *, audio_stream):
        # host us per packet: RTP header, TWCC, SRTP, the socket send
        t0 = time.perf_counter()
        wire = real_send_rtp(pc, pkt, audio_stream=audio_stream)
        if wire is not None:
            kind = "audio" if audio_stream else (
                "fec" if pkt.payload_type == pc._red_pt and pkt.payload[0] & 0x7F == pc._ulpfec_pt
                else "media")
            sent.append((t0, (time.perf_counter() - t0) * 1e6, kind))
        return wire

    out: dict = {"a": {}, "b": {}}
    me_mc.launches = 0
    t_phase = time.perf_counter()
    try:
        orch = Orchestrator(Config(values=values), device=dev)
        if len(built) != 1 or built[0].name != "tpuh264enc":
            _fail(f"phase 19 (a): the server built {[r.name for r in built]}")
        src = orch.app.source = _StampedSource(orch.app.source)
        gate = _Gate()
        orch.app.encoder = _Gated(orch.app.encoder, gate, ENCODER_CALLS)
        acked, forced, sends = [], [], []
        on_acked, on_forced = orch.webrtc.on_video_acked, orch.webrtc.on_force_keyframe
        rtc_send = orch.webrtc.send_video

        async def send_video(ef):
            if orch.webrtc.connected:
                sends.append((ef.timestamp_90k, time.perf_counter()))
            return await rtc_send(ef)
        orch.webrtc.send_video = send_video

        def acked_tap(seq, ms):
            acked.append(seq)
            on_acked(seq, ms)

        def forced_tap():
            forced.append(time.perf_counter())
            on_forced()
        orch.webrtc.on_video_acked, orch.webrtc.on_force_keyframe = acked_tap, forced_tap
        me_mc.me_mc, PeerConnection._send_rtp, IceAgent.gather = grabbing, send_rtp, gather

        async def go():
            task = asyncio.ensure_future(orch.run())
            await _wait_for(lambda: orch.server._runner is not None
                            and orch.server._runner.addresses, 60, "the server listening",
                            phase="19")
            base = f"http://127.0.0.1:{orch.server.bound_port}"
            async with aiohttp.ClientSession() as http:
                # (a) the clean link
                a, b = out["a"], RtcBrowser()
                ws, sig, fb, t = await _rtc_connect(http, base, b)
                a["times"] = dict(_rtc_times(t), server_gather_s=gathers[-1])
                pc1 = orch.webrtc.pc
                a["gathered"] = [(c.typ, c.ip) for c in pc1.ice.local_candidates]
                await _wait_for(lambda: b.aus, 120, "a first AU over WebRTC", phase="19")
                t_first = b.aus[0][0]
                await _wait_for(lambda: time.perf_counter() - t_first > 1.0, 5, "", phase="19")
                grab["armed"] = True
                for msg in RTC_INPUT:
                    b.send_text(msg)
                await _wait_for(lambda: time.perf_counter() - t_first > 2.0, 5, "", phase="19")
                n0, t0, s0, k0 = len(b.aus), time.perf_counter(), len(sent), len(acked)
                gcc0, x0 = orch.gcc.estimate_kbps, _rtx_sent(telemetry)
                await _wait_for(lambda: time.perf_counter() - t_first > RTC_S, 30, "",
                                phase="19")
                n1, t1, s1, gcc1 = len(b.aus), time.perf_counter(), len(sent), orch.gcc.estimate_kbps
                prof, wall_ms = await _live_profile(
                    gate, lambda: asyncio.sleep(SERVER_PROFILE_TICKS / SERVER_FPS))
                a["profile"] = dict(_device_activity(prof, wall_ms), ticks=SERVER_PROFILE_TICKS)
                a["window"] = {"aus": n1 - n0, "seconds": t1 - t0, "fps": (n1 - n0) / (t1 - t0),
                               "t": (t0, t1), "packets": sent[s0:s1],
                               "rtx_packets": _rtx_sent(telemetry) - x0,
                               "twcc_acked": len(acked) - k0, "gcc_kbps": (gcc0, gcc1)}
                # two PLIs inside the throttle: one forced IDR reaches the browser
                f0, n_pli = len(forced), len(b.aus)
                t_pli = time.perf_counter()
                b.send_pli()
                b.send_pli()
                await _wait_for(lambda: any(_is_idr(au) for _, _, au in b.aus[n_pli:]), 10,
                                "an IDR after the PLI", phase="19")
                a["pli"] = {"forced": len(forced) - f0,
                            "idr_after_ms": (next(tt for tt, _, au in b.aus[n_pli:]
                                                  if _is_idr(au)) - t_pli) * 1e3}
                # a NACK for a packet that arrived: its retransmission is the same datagram
                seq = (b.max_seq - 3) & 0xFFFF
                r0 = len(b.refused)
                b.send_nack([seq])
                await _wait_for(lambda: any(s == seq for s, _ in b.refused[r0:]), 10,
                                f"a retransmission of seq {seq}", phase="19")
                a["rtx_equal"] = all(d == b.raw[seq] for s, d in b.refused[r0:] if s == seq)
                await _wait_for(lambda: {"codec", "system", "ping", "system_stats"} <= {
                    _dc_type(x) for _, x in b.dc_texts}, 10, "the control messages", phase="19")
                a["browser"] = b
                a["rtx_after"] = _rtx_sent(telemetry)
                await _rtc_leave(ws, sig, fb, b)
                await _wait_for(lambda: orch.webrtc.pc is None and not orch._session_active
                                and (orch.app.pipeline is None or not orch.app.pipeline.running),
                                30, "the first session's stop", phase="19")
                a["pc_closed"] = pc1._closed
                # (b) a lossy link, the same server
                bo, b2 = out["b"], RtcBrowser()
                bo["mark"] = len(built[-1].outputs()), len(built)
                configure_faults(RTC_LOSS)
                try:
                    ws, sig, fb, t = await _rtc_connect(http, base, b2)
                    bo["times"] = dict(_rtc_times(t), server_gather_s=gathers[-1])
                    bo["fresh_peer"] = orch.webrtc.pc is not pc1 and orch.webrtc.pc._impair is not None
                    await _wait_for(lambda: b2.aus, 120, "a first AU over the lossy link",
                                    phase="19")
                    t_first = b2.aus[0][0]
                    await _wait_for(lambda: time.perf_counter() - t_first > RTC_LOSSY_S, 30, "",
                                    phase="19")
                    bo["fps"] = (len(b2.aus) - 1) / (b2.aus[-1][0] - t_first)
                    bo["rtx"] = _rtx_sent(telemetry) - a["rtx_after"]
                    bo["recovery"] = orch.recovery.stats()
                    await _rtc_leave(ws, sig, fb, b2)
                finally:
                    reset_faults()
                bo["faults_reset"] = get_injector() is None
                bo["browser"] = b2
                await _wait_for(lambda: orch.webrtc.pc is None and not orch._session_active
                                and (orch.app.pipeline is None or not orch.app.pipeline.running),
                                30, "the second session's stop", phase="19")
            for tk in orch._tasks:  # the in-process signalling client's /ws
                if tk.get_coro().__name__ == "_signalling_loop":
                    tk.cancel()
            await orch.server.stop()
            await asyncio.wait_for(task, 60)
        asyncio.run(go())
        for rec in built:  # the stream's last frames, still in flight
            rec.flush()
        launches = me_mc.launches  # the path's launches, before the checks launch
    finally:
        me_mc.me_mc, PeerConnection._send_rtp, IceAgent.gather = real_me_mc, real_send_rtp, real_gather
        restore()
        telemetry.disable()
        telemetry.reset()
        silent.close()
        if saved_display is not None:
            os.environ["DISPLAY"] = saved_display
    out["drive_s"] = time.perf_counter() - t_phase
    return _webrtc_checks(orch, built, out, grab, launches, dev, src, sends)


def _dc_type(text: str) -> str:
    try:
        obj = json.loads(text)
    except ValueError:
        return ""
    return obj.get("type", "") if isinstance(obj, dict) else ""


def _rtx_sent(telemetry) -> int:
    fam = telemetry.rollup()["counters"].get("selkies_rtx_packets_total", {})
    return int(sum(v for k, v in fam.items() if "sent" in k))


def _webrtc_checks(orch, built, out, grab, launches, dev, src, sends) -> dict:
    """Phase 19's checks on what the drive recorded."""
    from selkies_tpu_torch.models.h264 import me_mc

    a, bo = out["a"], out["b"]
    b, b2 = a.pop("browser"), bo.pop("browser")
    k1 = [rec.launches for rec in built]
    outs = [rec.outputs() for rec in built]
    # (a): the head of what the row returned, in order, byte for byte
    got = [au for _, _, au in b.aus]
    if [au for au, _, _ in outs[0]][:len(got)] != got or b.receiver.frames_frozen:
        _fail(f"phase 19 (a): the browser's {len(got)} AUs ({b.receiver.frames_frozen} frozen) "
              "are not the head of what the row returned")
    if not _is_idr(got[0]) or _sps_size(got[0]) != (W, H):
        _fail(f"phase 19 (a): the first AU is not a keyframe with a {W}x{H} SPS")
    for i, rec in enumerate(built):
        p = _p_count(outs[i])
        if k1[i] != p or p == 0:
            _fail(f"phase 19: encoder {i} launched K1 {k1[i]} times for {p} non-static P frames")
        if _replay(rec, device=rec.kw["device"]) != _shas(rec):
            _fail(f"phase 19: encoder {i}'s AUs differ from a direct card row's replay")
    if launches != sum(k1) + sum(rec.prewarm_launches for rec in built):
        _fail(f"phase 19: me_mc counted {launches} launches, the encoders {k1}")
    if "args" not in grab:
        _fail("phase 19 (a): no K1 launch after the warm-up to hold against its plain version")
    plain = me_mc.me_mc_plain(*grab["args"])
    err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(grab["out"], plain))
    if err:
        _fail(f"phase 19 (a): K1 differs from its plain version on a session P frame by {err}")
    events = orch.input.backend.events
    if not {("key", 65, True), ("key", 65, False), ("pos", 10, 20), ("button", 1, True),
            ("button", 1, False)} <= set(events):
        _fail(f"phase 19 (a): the data channel's input reached the backend as {events}")
    types = {_dc_type(x) for _, x in b.dc_texts}
    want = {"codec", "system", "ping", "system_stats"} | ({"gpu_stats"} if dev != "cpu" else set())
    if not want <= types:
        _fail(f"phase 19 (a): data channel messages {sorted(types)}, want {sorted(want)}")
    if orch.ws_transport.frames_sent or not orch.webrtc.frames_sent:
        _fail(f"phase 19: {orch.ws_transport.frames_sent} frames went over /media, "
              f"{orch.webrtc.frames_sent} over WebRTC")
    if a["pli"]["forced"] != 1 or not a["rtx_equal"]:
        _fail(f"phase 19 (a): two PLIs forced {a['pli']['forced']} IDRs; retransmission equal "
              f"{a['rtx_equal']}")
    win = a["window"]
    if win["twcc_acked"] <= 0:
        _fail("phase 19 (a): no TWCC feedback reached GCC in the window")
    if not a["pc_closed"]:
        _fail("phase 19 (a): the BYE did not close the peer")
    # capture -> send (WebRTCTransport.send_video) and -> browser delivery
    submits = [x[2] for attr, x, _, _ in built[0].log if attr == "submit"]
    cap_at = dict(zip(submits, src.captured_at))
    w0, w1 = win.pop("t")
    to_send = sorted((t - cap_at[ts]) * 1e3 for ts, t in sends if w0 <= t <= w1 and ts in cap_at)
    to_browser = sorted((t - cap_at[ts]) * 1e3 for t, ts, _ in b.aus
                        if w0 <= t <= w1 and ts in cap_at)
    pk = win.pop("packets")
    media = [us for _, us, kind in pk if kind != "audio"]
    n_fec = sum(1 for _, _, kind in pk if kind == "fec")
    win.update(capture_to_send_ms_median=statistics.median(to_send),
               capture_to_send_ms_p95=_pct(to_send, 95),
               capture_to_browser_ms_median=statistics.median(to_browser),
               capture_to_browser_ms_p95=_pct(to_browser, 95),
               video_packets=len(media), packets_per_au=len(media) / max(1, win["aus"]),
               packets_per_s=len(media) / win["seconds"],
               fec_share=n_fec / max(1, len(media)),
               rtx_share=win["rtx_packets"] / max(1, len(media)),
               send_rtp_us_median=statistics.median(media))
    # (b): a fresh handshake, a keyframe first, every complete AU the row's
    row = {}
    for i, rec_outs in enumerate(outs):
        start = bo["mark"][0] if i == bo["mark"][1] - 1 else (0 if i >= bo["mark"][1] else None)
        if start is not None:
            for au, _, ts in rec_outs[start:]:
                row.setdefault(ts & 0xFFFFFFFF, au)
    got2 = b2.aus
    if not bo["fresh_peer"] or b2.t_dtls is None or not got2 or not _is_idr(got2[0][2]):
        _fail("phase 19 (b): no fresh handshake, or the first AU is not a keyframe")
    bad = [ts for _, ts, au in got2 if row.get(ts) != au]
    if bad:
        _fail(f"phase 19 (b): {len(bad)} of {len(got2)} delivered AUs differ from the row's "
              "AU with their RTP timestamp")
    if bo["rtx"] <= 0 or not bo["faults_reset"]:
        _fail(f"phase 19 (b): {bo['rtx']} retransmissions answered the browser's NACKs; "
              f"faults reset {bo['faults_reset']}")
    st = b2.receiver.stats()
    bo.update(aus=len(got2), frozen=st["frames_frozen"], receiver=st,
              nacks_sent=len(b2.nacked), refused=len(b2.refused))
    a.update(aus=len(got), returned=len(outs[0]), p_frames=_p_count(outs[0]),
             me_mc_launches=k1, me_mc_plain_max_abs_err=err,
             me_mc_checked_shape=list(grab["args"][1].shape), input_events=len(events),
             control_types=sorted(types), receiver=b.receiver.stats(),
             audio_packets=b.audio_packets)
    out.update(me_mc_launches=launches, k1_session_launches=sum(k1),
               p_frames=sum(_p_count(o) for o in outs), encoders=len(built))
    for rec in built:
        rec.log.clear()
    return out


def _webrtc_phase(dev=None) -> dict:
    """Phase 19: the solo server over WebRTC (``dev`` None: the card)."""
    t0 = time.perf_counter()
    out = _webrtc_server("cuda" if dev is None else dev)
    card, limit = (s.strip() for s in _nvidia_smi().split(",", 1))
    out.update(card=card, power_limit=limit)
    a, b = out["a"], out["b"]
    print(f"phase 19 (a) Orchestrator(device={dev or 'cuda'}) tpuh264enc {W}x{H} {SERVER_FPS} fps "
          f"{SERVER_KBPS} kbps over WebRTC to RtcBrowser: gathered {a['gathered']}; "
          f"{a['aus']} AUs delivered = the head of the row's {a['returned']}, the first a "
          f"keyframe with its SPS; replay on a direct card row equal; K1 {a['me_mc_launches']} "
          f"launches = {a['p_frames']} non-static P frames, max |K1 - plain| "
          f"{a['me_mc_plain_max_abs_err']}; input over the data channel reached the "
          f"FakeBackend; control {a['control_types']} over the data channel; 2 PLIs -> "
          f"{a['pli']['forced']} IDR, at the browser {a['pli']['idr_after_ms']:.1f} ms later; "
          f"NACK -> the same datagram again; TWCC acked {a['window']['twcc_acked']} packets "
          f"({card}, {limit}) " + json.dumps({"times": a["times"], "window": a["window"],
                                               "profile": a["profile"]}))
    print(f"phase 19 (b) {RTC_LOSS}, a second browser: fresh DTLS, first AU a keyframe; "
          f"{b['aus']} AUs delivered, each equal to the row's AU of its RTP timestamp; "
          f"{b['frozen']} frozen; {b['rtx']} retransmissions for {b['nacks_sent']} NACKed seqs; "
          f"ladder {b['recovery']['rung_name']} (fec {b['recovery']['fec_pct']}%); "
          f"{b['fps']:.2f} fps ({card}, {limit}) " + json.dumps({"times": b["times"]}))
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 20: the fleet server and the cluster plane -------------------------------

FS_N, FS_W, FS_H = 8, 1920, 1088
FS_FPS = 60
FS_KBPS = 8000
FS_STEADY_S = 3.0
FS_PROFILE_TICKS = 10
FS_CPU_TICKS = 2  # the recorded ticks replayed on the CPU from the start
FC_N = 2  # sessions on each cluster host
FC_STREAM_S = 1.0  # seconds host A streams before it drains
FC_HEARTBEAT_S = 0.25
FC_SECRET = "phase20-cluster-secret"


def _fleet_argv(tmp: Path, n: int, w: int, h: int, port: int = 0) -> list:
    """``python -m selkies_tpu_torch``'s arguments for an n-session fleet
    server on the loopback, its STUN a silent loopback socket's."""
    return ["--tpu_sessions", str(n), "--addr", "127.0.0.1", "--port", str(port),
            "--capture_width", str(w), "--capture_height", str(h),
            "--framerate", str(FS_FPS), "--video_bitrate", str(FS_KBPS),
            "--encoder", "tpuh264enc", "--enable_clipboard", "false",
            "--json_config", str(tmp / "selkies_config.json"),
            "--rtc_config_json", str(tmp / "rtc.json")]


def _silent_stun(tmp: Path):
    """A STUN server on the loopback that never answers, named in the
    server's rtc.json: no outside host is contacted."""
    import socket

    silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silent.bind(("127.0.0.1", 0))
    (tmp / "rtc.json").write_text(json.dumps({"iceServers": [
        {"urls": [f"stun:127.0.0.1:{silent.getsockname()[1]}"]}]}))
    return silent


def _fleet_server(argv: list, dev):
    """FleetOrchestrator as ``main(argv, device=dev)`` builds it, its
    sources stamped and its batch service recorded behind a gate ->
    (orchestrator, recorder, gate)."""
    import torch

    from selkies_tpu_torch.config import parse_config
    from selkies_tpu_torch.parallel.fleet import FleetOrchestrator

    orch = FleetOrchestrator(parse_config(argv),
                             devices=None if dev is None else [torch.device(dev)])
    fleet = orch.fleet
    fleet.sources = [_StampedSource(s) for s in fleet.sources]
    gate = _Gate()
    rec = _RecordingService(fleet.service, {}, fleet.sources, 0.0)
    fleet.service = _Gated(rec, gate, ("encode_tick", "dispatch_tick", "complete_tick"))
    return orch, rec, gate


class _SyntheticFrames:
    """Session k's capture i of the fleet's synthetic source (seed k),
    rebuilt for a replay."""

    def __init__(self, n: int, w: int, h: int):
        from selkies_tpu_torch.pipeline.elements import SyntheticSource

        self.srcs = [SyntheticSource(w, h, seed=k) for k in range(n)]

    def batch(self, i: int):
        out = []
        for s in self.srcs:
            s._tick = i  # a capture's pixels depend on its tick alone
            out.append(s.capture())
        return np.stack(out)


def _probe_ticks(rec, ticks: list, n: int) -> dict:
    """(a)'s later ticks held against the CPU: the first and the last tick
    that codes a P frame of a session whose QP the rate control changed
    since its last tick, and the drain's IDR tick (the last with an IDR)
    -> {name: tick index}."""
    qp, at = [28] * n, []
    for ev in rec.log:
        if ev[0] == "set_qp":
            qp[ev[1]] = ev[2]
        elif ev[0] == "tick":
            at.append(list(qp))
    changed = [i for i in range(1, len(ticks))
               if any(at[i][k] != at[i - 1][k] and not ticks[i][2][k] for k in range(n))]
    idr = [i for i in range(1, len(ticks)) if any(ticks[i][2])]
    if not changed or not idr:
        _fail(f"phase 20 (a): no P tick after a QP change ({len(changed)}) or no IDR tick "
              f"after the first ({len(idr)}) among {len(ticks)} recorded ticks")
    return {"first_after_qp_change": changed[0], "last_after_qp_change": changed[-1],
            "drain_idr": idr[-1]}


def _check_probes(ticks: list, frames: _SyntheticFrames, snaps: dict, probes: dict,
                  cpu) -> None:
    """Each probed tick coded on the CPU from the card replay's state just
    before it (every session's GOP state and QP, the reference planes)
    gives the recorded AUs, and the reference planes the card replay held
    after it."""
    import torch

    try:
        for name, i in probes.items():
            state, ref = snaps[i]
            for sess, st in zip(cpu.sessions, state):
                sess.frames_since_idr, sess.idr_pic_id, sess.force_idr, sess.qp = st
            cpu.enc._ref = tuple(r.clone() for r in ref)
            aus = cpu.encode_tick(frames.batch(ticks[i][0]))
            got = [hashlib.sha256(au).hexdigest() for au in aus]
            if got != ticks[i][1] or list(cpu.last_idrs) != ticks[i][2]:
                _fail(f"phase 20 (a): tick {i} ({name}) differs on the CPU")
            if not all(torch.equal(x, y) for x, y in zip(cpu.enc._ref, snaps[i + 1][1])):
                _fail(f"phase 20 (a): tick {i}'s ({name}) reference planes differ on the CPU")
    finally:
        cpu.close()


def _contiguous(got: list, want: list) -> bool:
    """``got`` is a run of consecutive items of ``want``."""
    if not got or got[0] not in want:
        return False
    i = want.index(got[0])
    return want[i:i + len(got)] == got


def _counting(fn, calls: dict):
    """``fn`` adding one to ``calls[fn.__name__]`` at each call."""
    def call(*args):
        calls[fn.__name__] += 1
        return fn(*args)
    return call


def _fleet_server_run(dev, n: int, w: int, h: int) -> dict:
    """(a): the n-session fleet server on the card (``dev`` None), n - 1
    clients on /media/<k> and an RtcBrowser on the last session; the steady
    window, a profile over FS_PROFILE_TICKS ticks, then the drain."""
    import asyncio
    import os
    import tempfile

    import aiohttp

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.ops import colorspace
    from selkies_tpu_torch.parallel.fleet import browser_peer_id
    from selkies_tpu_torch.resilience import reset_device_pool
    from selkies_tpu_torch.transport.websocket import FLAG_KEYFRAME

    tmp = Path(tempfile.mkdtemp(prefix="selkies-phase20-"))
    silent = _silent_stun(tmp)
    saved_display = os.environ.pop("DISPLAY", None)  # the synthetic sources
    reset_device_pool()
    real = (me_mc.me_mc_batch, me_mc.me_mc_plain, me_mc.me_mc_batch_plain)
    grab, plain_calls = {}, {"me_mc_plain": 0, "me_mc_batch_plain": 0}

    def grabbing(*args):
        out = real[0](*args)
        if grab.get("armed") and "args" not in grab:
            grab["args"] = [a.clone() for a in args]
            grab["out"] = [o.clone() for o in out]
        return out

    out: dict = {}
    t_phase = time.perf_counter()
    try:
        orch, rec, gate = _fleet_server(_fleet_argv(tmp, n, w, h), dev)
        fleet = orch.fleet
        sends = [[] for _ in range(n)]
        for k, slot in enumerate(orch.slots):
            mux_send = slot.transport.send_video

            async def send_video(ef, k=k, mux_send=mux_send):
                sends[k].append((time.perf_counter(), len(fleet.sources[k].captured_at) - 1))
                return await mux_send(ef)
            slot.transport.send_video = send_video
        me_mc.me_mc_batch = grabbing
        me_mc.me_mc_plain, me_mc.me_mc_batch_plain = (_counting(f, plain_calls)
                                                      for f in real[1:])
        me_mc.launches = colorspace.launches = 0  # the main path's count starts here

        async def go():
            task = asyncio.ensure_future(orch.run())
            await _wait_for(lambda: orch.server._runner is not None
                            and orch.server._runner.addresses, 120, "the fleet listening",
                            phase="20")
            base = f"http://127.0.0.1:{orch.server.bound_port}"
            async with aiohttp.ClientSession() as http:
                out["healthz"] = (await http.get(base + "/healthz")).status
                clients = [await _media_client(http, base, k) for k in range(n - 1)]
                b = RtcBrowser()
                rws, sig, fb, t = await _rtc_connect(http, base, b, peer=browser_peer_id(n - 1))
                out["rtc_times"] = _rtc_times(t)
                await _wait_for(lambda: all(c.video for c in clients) and b.aus, 180,
                                "a first AU on every session", phase="20")
                t_all = time.perf_counter()
                await _wait_for(lambda: time.perf_counter() - t_all > 1.0, 5, "", phase="20")
                grab["armed"] = True

                def counts():
                    return [len(c.video) for c in clients] + [len(b.aus)]
                n0, t0, tick0 = counts(), time.perf_counter(), fleet.ticks
                await asyncio.sleep(FS_STEADY_S)
                n1, t1, tick1 = counts(), time.perf_counter(), fleet.ticks
                out["window"] = {"seconds": t1 - t0, "ticks": tick1 - tick0,
                                 "delivered": [y - x for x, y in zip(n0, n1)], "t": (t0, t1)}

                async def ticks(k=fleet.ticks):
                    while fleet.ticks < k + FS_PROFILE_TICKS:
                        await asyncio.sleep(0.001)
                prof, wall_ms = await _live_profile(gate, ticks)
                out["profile"] = dict(_device_activity(prof, wall_ms), ticks=FS_PROFILE_TICKS)
                # the drain with no cluster: every client must see an IDR and
                # stay until the hand-off, then leave so the server can stop
                for tk in orch._tasks:
                    if tk.get_coro().__name__ == "_slot_signalling_loop":
                        tk.cancel()
                marks = counts()
                t_drain = time.perf_counter()
                drain = asyncio.ensure_future(orch.drain())
                await _wait_for(lambda: orch.drain_checkpoints or drain.done(), 60,
                                "the drain's hand-off", phase="20")
                out["drain_idr"] = [any(f & FLAG_KEYFRAME for _, f, _, _ in c.video[m:])
                                    for c, m in zip(clients, marks)] + [
                    any(_is_idr(au) for _, _, au in b.aus[marks[-1]:])]
                await _rtc_leave(rws, sig, fb, b)
                # the readers stop first: a close racing a reader leaves the
                # server's handler open for aiohttp's close timeout
                for c in clients:
                    c.reader.cancel()
                await asyncio.gather(*(c.reader for c in clients), return_exceptions=True)
                await asyncio.gather(*(c.ws.close() for c in clients))
                out["drained"] = await asyncio.wait_for(drain, 60)
                out["drain_s"] = time.perf_counter() - t_drain
            await asyncio.wait_for(task, 60)
            return clients, b
        clients, b = asyncio.run(go())
        launches = me_mc.launches  # read before the checks launch below
        conv_launches = colorspace.launches
    finally:
        me_mc.me_mc_batch, me_mc.me_mc_plain, me_mc.me_mc_batch_plain = real
        silent.close()
        reset_device_pool()
        if saved_display is not None:
            os.environ["DISPLAY"] = saved_display
    out["drive_s"] = time.perf_counter() - t_phase
    out.update(orch=orch, rec=rec, clients=clients, browser=b, sends=sends, grab=grab,
               launches=launches, conv_launches=conv_launches, plain_calls=plain_calls)
    return out


def _fleet_server_checks(run: dict, dev, n: int, w: int, h: int) -> dict:
    """(a)'s checks: the sent AUs are their session's recorded ones, the
    recorded ticks equal their replay on the card (and their head on the
    CPU), K1 once per tick with a P session and its plain version never."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
    from selkies_tpu_torch.transport.websocket import FLAG_KEYFRAME

    orch, rec, clients, b = run["orch"], run["rec"], run["clients"], run["browser"]
    ticks = rec.ticks()
    empty = hashlib.sha256(b"").hexdigest()
    for k in range(n):
        want = [t[1][k] for t in ticks if t[1][k] != empty]
        got = ([hashlib.sha256(p).hexdigest() for *_, p in clients[k].video] if k < n - 1
               else [hashlib.sha256(au).hexdigest() for _, _, au in b.aus])
        if not _contiguous(got, want):
            _fail(f"phase 20 (a): session {k}'s {len(got)} AUs are not a run of its "
                  f"{len(want)} recorded ones")
    # a client that connects while a tick encodes gets that tick's P frame
    # first (JAX's fleet does the same); its forced keyframe is the next
    keys = [next((p for _, f, _, p in c.video[:2] if f & FLAG_KEYFRAME), None)
            for c in clients] + [next((au for _, _, au in b.aus[:2] if _is_idr(au)), None)]
    if not all(p is not None and _sps_size(p) == (w, h) for p in keys):
        _fail(f"phase 20 (a): a session's first two AUs hold no keyframe with a {w}x{h} SPS")
    with_p = sum(1 for t in ticks if not all(t[2]))
    # on the card the kernel, never its plain version; on the CPU (a
    # rehearsal) the plain version, never the kernel
    # the stop may cancel a last tick between its dispatch and its completion
    cut = sum(1 for e in rec.log if e[0] == "tick") - len(ticks)
    plain = run["plain_calls"]["me_mc_batch_plain"]
    kernel, other = (run["launches"], plain) if dev is None else (plain, run["launches"])
    if run["launches"] != rec.launches or not with_p <= kernel <= with_p + cut or \
            with_p == 0 or other or \
            (dev is None and run["plain_calls"]["me_mc_plain"]):
        _fail(f"phase 20 (a): K1 launched {run['launches']} times ({rec.launches} inside the "
              f"service's ticks), its plain versions {run['plain_calls']}, for {with_p} ticks "
              "with a P session")
    # the service's one group converts every tick it dispatches on the card
    conv = run["conv_launches"]
    if not (len(ticks) <= conv <= len(ticks) + cut if dev is None else conv == 0):
        _fail(f"phase 20 (a): bgrx_to_i420 launched {conv} times for {len(ticks)} ticks "
              f"({cut} cut)")
    card = dev or "cuda"
    t0 = time.perf_counter()
    frames = _SyntheticFrames(n, w, h)
    probes = _probe_ticks(rec, ticks, n)
    snaps = {}

    def snap(i, svc):
        if i in probes.values() or i - 1 in probes.values():
            snaps[i] = ([(s.frames_since_idr, s.idr_pic_id, s.force_idr, s.qp)
                         for s in svc.sessions],
                        tuple(r.to("cpu", copy=True) for r in svc.enc._ref))

    def service(device):
        return lambda: TorchMultiSessionH264Service(n, w, h, qp=28, fps=FS_FPS, device=device)
    replay = _replay_service(rec, frames.batch, service(card), before=snap)
    replay_s = time.perf_counter() - t0
    if [r[:3] for r in replay[:len(ticks)]] != ticks or len(replay) - len(ticks) > 1:
        _fail(f"phase 20 (a): the {len(ticks)} recorded ticks differ from their card replay")
    t0 = time.perf_counter()
    cpu = _replay_service(rec, frames.batch, service("cpu"), ticks=FS_CPU_TICKS)
    if [r[:3] for r in cpu] != ticks[:FS_CPU_TICKS]:
        _fail(f"phase 20 (a): the first {FS_CPU_TICKS} ticks differ on the CPU")
    _check_probes(ticks, frames, snaps, probes, service("cpu")())
    cpu_s = time.perf_counter() - t0
    grab = run["grab"]
    if "args" not in grab:
        _fail("phase 20 (a): no K1 launch after the warm-up to hold against its plain version")
    plain = me_mc.me_mc_batch_plain(*grab["args"])
    err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(grab["out"], plain))
    if err:
        _fail(f"phase 20 (a): K1 differs from its plain version on a fleet tick by {err}")
    if not run["drained"] or not all(run["drain_idr"]) or \
            sorted(ck.session for ck in orch.drain_checkpoints) != list(range(n)):
        _fail(f"phase 20 (a): drain {run['drained']}, IDR after the drain {run['drain_idr']}, "
              f"checkpoints {[ck.session for ck in orch.drain_checkpoints]}")
    if run["healthz"] != 200 or orch.fleet.supervisor.counters["failures"]:
        _fail(f"phase 20 (a): /healthz {run['healthz']}, supervisor "
              f"{orch.fleet.supervisor.counters}")
    if (dev is None) != (orch.device_mon is not None) or \
            str(getattr(orch.fleet.service, "device", card)).split(":")[0] != \
            torch.device(card).type:
        _fail(f"phase 20 (a): device monitor {orch.device_mon}, service on "
              f"{orch.fleet.service.device}")
    win = run["window"]
    t0w, t1w = win.pop("t")
    lat = sorted((t - orch.fleet.sources[k].captured_at[i]) * 1e3
                 for k in range(n) for t, i in run["sends"][k] if t0w <= t <= t1w)
    ck = json.loads(orch.drain_checkpoints[0].to_json())
    return {"sessions": n, "geometry": f"{w}x{h}", "fps": sum(win["delivered"]) / win["seconds"],
            "window": win, "capture_to_send_ms_median": statistics.median(lat),
            "capture_to_send_ms_p95": _pct(lat, 95), "profile": run["profile"],
            "rtc_times": run["rtc_times"], "ticks_recorded": len(ticks),
            "ticks_with_p": with_p, "me_mc_launches": run["launches"],
            "colorspace_launches": conv,
            "me_mc_plain_calls": run["plain_calls"], "me_mc_plain_max_abs_err": err,
            "me_mc_checked_shape": list(grab["args"][1].shape), "card_replay_s": replay_s,
            "cpu_replay_ticks": FS_CPU_TICKS, "cpu_probe_ticks": probes, "cpu_replay_s": cpu_s,
            "drain_s": run["drain_s"], "checkpoints": len(orch.drain_checkpoints),
            "checkpoint_fields": sorted(ck), "drive_s": run["drive_s"]}


async def _media_client(http, base: str, k: int):
    """A _ServerClient reading /media/<k> in a task of its own."""
    import asyncio

    c = _ServerClient(await http.ws_connect(f"{base}/media/{k}"))
    c.reader = asyncio.ensure_future(c.read())
    return c


def _cluster_run(dev, n: int, w: int, h: int) -> dict:
    """(b): hosts A and B, each an n-session fleet server on the one card
    with SELKIES_CLUSTER_* naming the other (read as each is built), a
    real HttpMigrationChannel under SELKIES_CLUSTER_SECRET. A client holds
    signalling (HELLO 1) and /media/0 on A; A drains; the session ships to
    B; the client follows the REDIRECT to B's /ws and /media/<landing>."""
    import asyncio
    import base64
    import os
    import tempfile

    import aiohttp

    from selkies_tpu_torch.cluster import parse_redirect
    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.parallel.fleet import browser_peer_id
    from selkies_tpu_torch.resilience import reset_device_pool

    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    keys = ("SELKIES_CLUSTER_PEERS", "SELKIES_CLUSTER_SELF", "SELKIES_CLUSTER_SECRET",
            "SELKIES_CLUSTER_HEARTBEAT_S", "SELKIES_CLUSTER_LEASE_S", "DISPLAY")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.pop("DISPLAY", None)
    reset_device_pool()
    hosts, silent = [], []
    out: dict = {}
    try:
        for i in range(2):
            tmp = Path(tempfile.mkdtemp(prefix=f"selkies-phase20-{'ab'[i]}-"))
            silent.append(_silent_stun(tmp))
            os.environ.update({"SELKIES_CLUSTER_SELF": urls[i],
                               "SELKIES_CLUSTER_PEERS": urls[1 - i],
                               "SELKIES_CLUSTER_SECRET": FC_SECRET,
                               "SELKIES_CLUSTER_HEARTBEAT_S": str(FC_HEARTBEAT_S),
                               "SELKIES_CLUSTER_LEASE_S": str(40 * FC_HEARTBEAT_S)})
            hosts.append(_fleet_server(_fleet_argv(tmp, n, w, h, port=ports[i]), dev))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            elif k != "DISPLAY":
                os.environ[k] = v
    (a, rec_a, _), (b, rec_b, _) = hosts
    if a.cluster is None or b.cluster is None or a.drainer._migrate is None:
        _fail("phase 20 (b): the cluster plane was not wired on both hosts")
    stamps = {}
    handle = b.cluster.target.handle

    def handle_tap(payload):
        stamps["restore_at"] = time.perf_counter()
        ack = handle(payload)
        stamps["acked_at"] = time.perf_counter()
        stamps["checkpoint"] = payload["checkpoint"]
        return ack
    b.cluster.target.handle = handle_tap
    redirect_peer = a.server.redirect_peer

    async def redirect_tap(uid, rd):
        stamps["redirect_at"] = time.perf_counter()
        return await redirect_peer(uid, rd)
    a.server.redirect_peer = redirect_tap
    start_b, receive_a = b.cluster.start, a.cluster.node.receive

    async def start_tap():
        stamps["b_beats_at"] = time.perf_counter()
        await start_b()
    b.cluster.start = start_tap

    def receive_tap(body, sig=""):
        ok = receive_a(body, sig)
        if ok and "b_alive_at" not in stamps and a.cluster.node.peer_alive(urls[1]):
            stamps["b_alive_at"] = time.perf_counter()
        return ok
    a.cluster.node.receive = receive_tap
    send_a = a.cluster.channel.send

    async def ship_tap(host, payload):
        stamps["ship_at"] = time.perf_counter()
        ack = await send_a(host, payload)
        stamps["ship_acked_at"] = time.perf_counter()
        return ack
    a.cluster.channel.send = ship_tap
    b_send = b.slots[0].transport.send_video

    async def b_send_tap(ef):
        stamps.setdefault("b_first_send_at", time.perf_counter())
        return await b_send(ef)
    b.slots[0].transport.send_video = b_send_tap
    meta = base64.b64encode(json.dumps({"codecs": ["h264"]}).encode()).decode()
    t_phase = time.perf_counter()

    async def go():
        tasks = [asyncio.ensure_future(o.run()) for o in (a, b)]
        for o in (a, b):
            await _wait_for(lambda o=o: o.server._runner is not None
                            and o.server._runner.addresses, 120, "a cluster host listening",
                            phase="20")
        await _wait_for(lambda: "b_alive_at" in stamps, 30, "host B alive on host A",
                        phase="20")
        async with aiohttp.ClientSession() as http:
            sig = await http.ws_connect(urls[0] + "/ws")
            await sig.send_str(f"HELLO {browser_peer_id(0)} {meta}")
            hello = await sig.receive()
            if hello.data != "HELLO":
                _fail(f"phase 20 (b): host A answered the HELLO with {hello.data!r}")
            ca = await _media_client(http, urls[0], 0)
            await _wait_for(lambda: len(ca.video) >= 2, 120, "AUs on host A", phase="20")
            t_a = time.perf_counter()
            await _wait_for(lambda: time.perf_counter() - t_a > FC_STREAM_S, 5, "", phase="20")
            n_a = len(ca.video)
            drain = asyncio.ensure_future(a.drain())
            while True:  # the slot's offer may come first: the client reads on
                msg = await asyncio.wait_for(sig.receive(), 60)
                if msg.type != aiohttp.WSMsgType.TEXT or msg.data.startswith("REDIRECT "):
                    break
            stamps["redirect_seen_at"] = time.perf_counter()
            rd = parse_redirect(msg.data) if msg.type == aiohttp.WSMsgType.TEXT else None
            if rd is None or rd.host != urls[1] or rd.reason != "migrated":
                _fail(f"phase 20 (b): the client got {msg.type} {str(msg.data)[:80]!r}")
            # host A's slots' in-process signalling clients leave once the
            # record is out (their sessions' partner is the client; A's
            # server stops only when every socket has closed)
            for tk in a._tasks:
                if tk.get_coro().__name__ == "_slot_signalling_loop":
                    tk.cancel()
            await ca.ws.close()
            await sig.close()
            landing = rd.session if rd.session is not None else 0
            sig_b = await http.ws_connect(urls[1] + "/ws")
            await sig_b.send_str(f"HELLO {browser_peer_id(landing)} {meta}")
            hello_b = await sig_b.receive()
            cb = await _media_client(http, urls[1], landing)
            await _wait_for(lambda: cb.video, 120, "the first AU on host B", phase="20")
            stamps["client_first_au_at"] = cb.video[0][0]
            out["drained"] = await asyncio.wait_for(drain, 60)
            await _wait_for(lambda: len(cb.video) >= 3, 60, "AUs on host B", phase="20")
            out["hello_b"] = hello_b.data
            out["landing"] = landing
            out["a_video_before_drain"] = n_a
            out["migrated"] = list(a.drainer.migrated)
            out["b_connected"] = b.slots[landing].connected
            # the claimed slot leaves the claim window; nothing expires
            out["expired"] = b.cluster.target.expire_claims()
            out["claims_after"] = sorted(b.cluster.target.pending_claims)
            out["alive_b_on_a"] = a.cluster.node.peer_alive(urls[1])
            out["statz_b"] = await (await http.get(urls[1] + "/statz")).text()
            for tk in b._tasks:
                if tk.get_coro().__name__ == "_slot_signalling_loop":
                    tk.cancel()
            await sig_b.close()
            await cb.ws.close()
            await asyncio.gather(ca.reader, cb.reader, return_exceptions=True)
        await asyncio.wait_for(tasks[0], 60)  # A's drain stopped its server
        await b.server.stop()
        await asyncio.wait_for(tasks[1], 60)
        return ca, cb
    real = (me_mc.me_mc_plain, me_mc.me_mc_batch_plain)
    plain_calls = {"me_mc_plain": 0, "me_mc_batch_plain": 0}
    me_mc.me_mc_plain, me_mc.me_mc_batch_plain = (_counting(f, plain_calls) for f in real)
    me_mc.launches = 0  # the cluster path's count starts here: both hosts' ticks
    try:
        ca, cb = asyncio.run(go())
        launches = me_mc.launches  # read before the oracle launches below
    finally:
        me_mc.me_mc_plain, me_mc.me_mc_batch_plain = real
        for s in silent:
            s.close()
        reset_device_pool()
        if saved["DISPLAY"] is not None:
            os.environ["DISPLAY"] = saved["DISPLAY"]
    out.update(drive_s=time.perf_counter() - t_phase, a=a, b=b, rec_a=rec_a, rec_b=rec_b,
               ca=ca, cb=cb, stamps=stamps, launches=launches, plain_calls=plain_calls)
    return out


def _cluster_checks(run: dict, dev, n: int, w: int, h: int) -> dict:
    """(b)'s checks: the session moved (released on A, claimed on B), B's
    first AU of it is the recovery IDR, and it and the P frames after it
    equal the card's own uninterrupted oracle: A's recorded calls replayed
    into one direct service that then codes B's frames with B's QPs."""
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    a, b, st = run["a"], run["b"], run["stamps"]
    k2 = run["landing"]
    if not run["drained"] or run["migrated"] != [0] or a.fleet.placer.row(0) or \
            not run["b_connected"] or run["expired"] or run["claims_after"] or \
            run["hello_b"] != "HELLO":
        _fail(f"phase 20 (b): drained {run['drained']}, migrated {run['migrated']}, A's row 0 "
              f"{a.fleet.placer.row(0)}, B's slot connected {run['b_connected']}, expired "
              f"{run['expired']}, claims {run['claims_after']}, B's HELLO {run['hello_b']!r}")
    ticks_a, ticks_b = run["rec_a"].ticks(), run["rec_b"].ticks()
    # the two hosts tick in one process: K1's count is both hosts' ticks
    # with a P session (a stop may cut a host's last tick after its launch)
    with_p = sum(1 for t in ticks_a + ticks_b if not all(t[2]))
    cut = sum(1 for rec in (run["rec_a"], run["rec_b"]) for e in rec.log
              if e[0] == "tick") - len(ticks_a) - len(ticks_b)
    plain = run["plain_calls"]["me_mc_batch_plain"]
    kernel, other = (run["launches"], plain) if dev is None else (plain, run["launches"])
    if not with_p <= kernel <= with_p + cut or with_p == 0 or other or \
            (dev is None and run["plain_calls"]["me_mc_plain"]):
        _fail(f"phase 20 (b): K1 launched {run['launches']} times, its plain versions "
              f"{run['plain_calls']}, for {with_p} ticks with a P session on A and B "
              f"({cut} cut)")
    ck = json.loads(st["checkpoint"])
    frames = _SyntheticFrames(n, w, h)
    card = dev or "cuda"
    oracle = TorchMultiSessionH264Service(n, w, h, qp=28, fps=FS_FPS, device=card)
    try:
        _feed(oracle, run["rec_a"].log, frames.batch)
        # A serves the session on while the ship is in flight, so its last
        # P frames may postdate the checkpoint; no IDR does (the drain's
        # forced IDR came before the migrate-off), so the GOP phase agrees
        if ck["idr_pic_id"] != oracle.sessions[0].idr_pic_id or \
                ck["frames_since_idr"] > oracle.sessions[0].frames_since_idr:
            _fail(f"phase 20 (b): the checkpoint {ck} is not A's state")
        oracle.force_keyframe(0)
        # B's ticks with the landing session's frame and QP in session 0's place
        log_b = run["rec_b"].log
        got, want, qp = [], [], None
        for ev in log_b:
            if ev[0] == "set_qp" and ev[1] == k2:
                qp = ev[2]
            elif ev[0] == "tick":
                batch = frames.batch(ev[1])
                batch[0] = batch[k2].copy()
                if qp is not None:
                    oracle.set_qp(0, qp)
                want.append((hashlib.sha256(oracle.encode_tick(batch)[0]).hexdigest(),
                             bool(oracle.last_idrs[0])))
            elif ev[0] == "aus":
                got.append((ev[1][k2], bool(ev[2][k2])))
            if len(got) == 3:
                break
    finally:
        oracle.close()
    if not got or not got[0][1] or got != want[:len(got)]:
        _fail(f"phase 20 (b): B's first AUs of the session {got} differ from the oracle's "
              f"{want[:len(got)]}")
    sent = [hashlib.sha256(p).hexdigest() for *_, p in run["cb"].video]
    if sent[:len(got)] != [g[0] for g in got]:
        _fail("phase 20 (b): the client's first AUs on B are not B's first AUs of the session")
    first_tick_b = next(i for i, t in enumerate(ticks_b) if t[1][k2] != hashlib.sha256(
        b"").hexdigest())
    return {"hosts": 2, "sessions_per_host": n, "geometry": f"{w}x{h}",
            "heartbeat_s": FC_HEARTBEAT_S,
            "heartbeat_to_alive_s": st["b_alive_at"] - st["b_beats_at"],
            "ship_to_ack_ms": (st["ship_acked_at"] - st["ship_at"]) * 1e3,
            "restore_ms": (st["acked_at"] - st["restore_at"]) * 1e3,
            "checkpoint_to_first_au_ms": (st["b_first_send_at"] - st["ship_at"]) * 1e3,
            "redirect_to_client_first_au_ms": (st["client_first_au_at"] - st["redirect_at"])
            * 1e3,
            "redirect_sent_to_seen_ms": (st["redirect_seen_at"] - st["redirect_at"]) * 1e3,
            "landing": k2, "oracle_equal_aus": len(got), "ticks_a": len(ticks_a),
            "ticks_b": len(ticks_b), "first_tick_b_with_session": first_tick_b,
            "me_mc_launches": run["launches"], "ticks_with_p": with_p,
            "me_mc_plain_calls": run["plain_calls"],
            "signed": True, "drive_s": run["drive_s"]}


def _fleet_server_phase(dev=None, loop_fps: float | None = None, n: int = FS_N,
                        w: int = FS_W, h: int = FS_H, cluster_n: int = FC_N) -> dict:
    """Phase 20: (a) the fleet server, (b) two cluster hosts and a live
    migration (``dev`` None: the card)."""
    from selkies_tpu_torch.monitoring.telemetry import telemetry
    from selkies_tpu_torch.resilience import faultinject

    _set_hooks(False)
    faultinject.reset_faults()
    out: dict = {}
    t0 = time.perf_counter()
    run = _fleet_server_run(dev, n, w, h)
    out["a"] = _fleet_server_checks(run, dev, n, w, h)
    out["a"]["seconds"] = time.perf_counter() - t0
    a = out["a"]
    if loop_fps:
        a["share_of_phase17_loop"] = a["fps"] / loop_fps
    card, limit = (s.strip() for s in _nvidia_smi().split(",", 1)) if dev is None else (dev, "-")
    print(f"phase 20 (a) FleetOrchestrator --tpu_sessions {n} {w}x{h} {FS_FPS} fps {FS_KBPS} "
          f"kbps, {n - 1} /media clients and an RtcBrowser: every session's AUs a run of its "
          f"recorded ones, a keyframe with its SPS among the first two; {a['ticks_recorded']} "
          f"ticks equal "
          f"their card replay, the first {FS_CPU_TICKS} and ticks "
          f"{json.dumps(a['cpu_probe_ticks'])} (each from the card replay's state) the "
          f"CPU's; K1 {a['me_mc_launches']} "
          f"launches = {a['ticks_with_p']} ticks with a P session, plain versions "
          f"{json.dumps(a['me_mc_plain_calls'])}, max |K1 - plain| "
          f"{a['me_mc_plain_max_abs_err']}; "
          f"the drain force-IDRed every client and handed off {a['checkpoints']} checkpoints; "
          f"{a['fps']:.2f} fps across sessions"
          + (f" = {a['share_of_phase17_loop']:.3f} of phase 17's loop ({loop_fps:.2f})"
             if loop_fps else "")
          + f"; capture->send {a['capture_to_send_ms_median']:.2f} ms median, "
          f"{a['capture_to_send_ms_p95']:.2f} p95 ({card}, {limit}) "
          + json.dumps({"window": a["window"], "profile": a["profile"],
                        "rtc_times": a["rtc_times"],
                        "seconds": {k: a[k] for k in ("drive_s", "drain_s", "card_replay_s",
                                                      "cpu_replay_s")}})
          + f"; {a['seconds']:.1f} s")
    t0 = time.perf_counter()
    telemetry.disable()
    run = _cluster_run(dev, cluster_n, w, h)
    out["b"] = _cluster_checks(run, dev, cluster_n, w, h)
    out["b"]["seconds"] = time.perf_counter() - t0
    bo = out["b"]
    print(f"phase 20 (b) two hosts x --tpu_sessions {cluster_n} at {w}x{h}, signed heartbeats "
          f"every {FC_HEARTBEAT_S} s, HttpMigrationChannel: host A drained, session 0 landed on "
          f"B's slot {bo['landing']}, the client followed the REDIRECT; B's first "
          f"{bo['oracle_equal_aus']} AUs of it (the first the recovery IDR) equal the card's "
          f"uninterrupted oracle; K1 {bo['me_mc_launches']} launches = {bo['ticks_with_p']} "
          f"ticks with a P session on A and B, plain versions "
          f"{json.dumps(bo['me_mc_plain_calls'])}; heartbeat -> alive "
          f"{bo['heartbeat_to_alive_s']:.3f} s, ship "
          f"-> ack {bo['ship_to_ack_ms']:.1f} ms (B's restore {bo['restore_ms']:.1f} ms), "
          f"checkpoint -> B's first AU "
          f"{bo['checkpoint_to_first_au_ms']:.1f} ms, redirect -> the client's first AU "
          f"{bo['redirect_to_client_first_au_ms']:.1f} ms ({card}, {limit}); "
          f"{bo['seconds']:.1f} s")
    out.update(card=card, power_limit=limit)
    return out


# -- phase 21: the multi-card carve ------------------------------------------------------

CARVE_CFGS = {  # name -> (w, h, bands, cols)
    "bands4_1080p": (1920, 1080, 4, 1),
    "grid2x2_1080p": (1920, 1080, 2, 2),
    "grid3x2_4k": (3840, 2160, 3, 2),
}
CARVE_COLS = (2, 4)  # (b): the column front-end's meshes
CARVE_GROUPS = 2  # (c): the session groups of the 8-session service


def _carve_cards(k: int) -> tuple:
    """-> (k devices, how they were picked): k distinct cards where the
    machine has them, else cuda:0 listed k times."""
    import torch

    if torch.cuda.device_count() >= k:
        return [torch.device("cuda", i) for i in range(k)], "distinct"
    return [torch.device("cuda", 0)] * k, "one card repeated"


def _carve_trace(w: int, h: int) -> list:
    """-> [(frame, op)]: phase 8's desktop (IDR), 4 full-motion scrolls of
    24 rows, a static repeat, a forced IDR on a fifth scroll and a QP change
    (36) on a sixth."""
    base = _band_trace(w, h)[0][0]
    scroll = [np.roll(base, -24 * (k + 1), 0) for k in range(6)]
    return ([(base, None)] + [(f, None) for f in scroll[:4]] + [(scroll[3].copy(), None),
            (scroll[4], "idr"), (scroll[5], ("qp", 36))])


def _carve_drive(enc, trace) -> list:
    """-> per frame (sha256, kind "I" / "P" / "S", K1 launches, step ms,
    device ms, bytes exchanged between shards)."""
    from selkies_tpu_torch.models.h264 import me_mc

    out = []
    for frame, op in trace:
        qp = None
        if op == "idr":
            enc.force_keyframe()
        elif op is not None:
            qp = op[1]
        moved0 = sum(enc.shard_bytes.snapshot().values())
        k0 = me_mc.launches
        au = enc.encode_frame(frame, qp)
        st = enc.last_stats
        kind = "I" if st.idr else ("S" if st.upload_kind == "static" else "P")
        out.append((hashlib.sha256(au).hexdigest(), kind, me_mc.launches - k0,
                    st.step_ms, st.device_ms, sum(enc.shard_bytes.snapshot().values()) - moved0))
    return out


def _recon_devices(enc) -> list:
    """The device of every tile's reference luma, as the (bands, cols) grid."""
    ref = enc._ref[0]
    if enc.mesh_enabled:
        return [[str(t.device) for t in row] for row in ref]
    return [[str(ref.device)] * enc.cols for _ in range(enc.bands)]


def _carve_phase(timing: bool, ses_shas: list) -> dict:
    """Phase 21: (a) the band and tile meshes against the stacked path on
    the card, (b) the column front-end's mesh against one card, (c) the
    8-session service in 2 groups against phase 9's one-card service."""
    import torch

    from selkies_tpu_torch.models.h264 import me_mc
    from selkies_tpu_torch.ops import colorspace
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
    from selkies_tpu_torch.parallel.codec_mesh import MeshDeltaFrontend
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    out: dict = {"cards": torch.cuda.device_count()}
    plain = {"me_mc_plain": 0, "me_mc_batch_plain": 0}
    real = (me_mc.me_mc_plain, me_mc.me_mc_batch_plain)
    me_mc.me_mc_plain = _counting(real[0], plain)
    me_mc.me_mc_batch_plain = _counting(real[1], plain)
    t_part = time.perf_counter()
    try:
        # (a) the band and tile meshes
        out["a"] = {}
        for name, (w, h, bands, cols) in CARVE_CFGS.items():
            devs, how = _carve_cards(bands * cols)
            trace = _carve_trace(w, h)
            mesh = TorchBandedH264Encoder(w, h, qp=28, bands=bands, cols=cols, devices=devs)
            if not mesh.mesh_enabled or (mesh.bands, mesh.cols) != (bands, cols):
                _fail(f"phase 21 (a) {name}: carve {mesh.bands}x{mesh.cols}, mesh "
                      f"{mesh.mesh_enabled} on {len(devs)} devices")
            got = _carve_drive(mesh, trace)
            recon = _recon_devices(mesh)
            prof = None
            if timing:
                scrolls = _scroll_run(w, h, 6)[2:]
                prof = _profile_frames(mesh, scrolls, False, 4, feed=lambda i: scrolls[i])
            mesh.close()
            stacked = TorchBandedH264Encoder(w, h, qp=28, bands=bands, cols=cols,
                                             device="cuda:0")
            want = _carve_drive(stacked, trace)
            stacked.close()
            bad = [i for i, (g, s) in enumerate(zip(got, want)) if g[0] != s[0]]
            if bad:
                _fail(f"phase 21 (a) {name}: the mesh's AUs differ from the stacked path's at "
                      f"frames {bad}")
            kinds = "".join(g[1] for g in got)
            if kinds != "IPPPPSIP":
                _fail(f"phase 21 (a) {name}: frame kinds {kinds}")
            launches = [g[2] for g in got]
            if launches != [bands * cols if k == "P" else 0 for k in kinds]:
                _fail(f"phase 21 (a) {name}: K1 launches per frame {launches}")
            moved = [g[5] for g in got if g[1] == "P"]

            def med(rows, kind, i):
                vals = [r[i] for r in rows if r[1] == kind]
                return statistics.median(vals) if vals else None

            out["a"][name] = {
                "devices": how, "carve": f"{bands}x{cols}", "kinds": kinds,
                "recon_devices": recon, "me_mc_launches": launches,
                "sha256": [g[0] for g in got], "bytes_between_shards_per_p": moved,
                "step_ms": {k: {"mesh": med(got, k, 3), "stacked": med(want, k, 3)}
                            for k in ("I", "P")},
                "device_ms": {k: {"mesh": med(got, k, 4), "stacked": med(want, k, 4)}
                              for k in ("I", "P")},
                "profile_p": prof}
            act = {k: prof.get(k) for k in ("device_ops", "device_idle_share", "wall_ms")
                   } if prof else "with the timing only"
            print(f"phase 21 (a) {name} {w}x{h} {bands}x{cols} on {how} "
                  f"({[str(d) for d in devs]}): {kinds} AUs sha256-equal the stacked path on "
                  f"cuda:0; K1 {launches}; bytes between shards per P {moved}; reference "
                  f"planes on {recon}; step ms mesh / stacked: P {med(got, 'P', 3):.2f} / "
                  f"{med(want, 'P', 3):.2f}, IDR {med(got, 'I', 3):.2f} / "
                  f"{med(want, 'I', 3):.2f}; mesh over 4 P frames {json.dumps(act)}")
        out["a_seconds"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (b) the column front-end
        trace = _hybrid_trace()
        out["b"] = {}
        for cols in CARVE_COLS:
            devs, how = _carve_cards(cols)
            mesh = MeshDeltaFrontend(W, H, cols, devices=devs)
            one = MeshDeltaFrontend(W, H, cols, devices=[torch.device("cuda", 0)])
            if not mesh.mesh_enabled or one.mesh_enabled:
                _fail(f"phase 21 (b) cols={cols}: mesh {mesh.mesh_enabled}, one card "
                      f"{one.mesh_enabled}")
            g, c = _drive_mesh(mesh, trace), _drive_mesh(one, trace)
            for i, ((gd, gh), (cd, ch)) in enumerate(zip(g, c)):
                if (gd is None) != (cd is None) or (cd is not None and (
                        not np.array_equal(gd, cd) or not np.array_equal(gh, ch))):
                    _fail(f"phase 21 (b) cols={cols} frame {i}: the mesh's map or hints "
                          "differ from the one-card front-end's")
            out["b"][f"cols{cols}"] = {"devices": how, "steps": len(g), "votes": mesh.votes,
                                       "dirty_mbs": [None if d is None else int(d.sum())
                                                     for d, _ in g]}
            print(f"phase 21 (b) MeshDeltaFrontend {W}x{H} cols={cols} on {how}: {len(g)} "
                  f"steps, maps and hints equal the one-card front-end's")
        out["b_seconds"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (c) the session groups
        devs, how = _carve_cards(CARVE_GROUPS)
        bases = [_session_base(i, SW, SH) for i in range(8)]
        svc = TorchMultiSessionH264Service(8, SW, SH, qp=28, devices=devs)
        timings = []
        real_tick = svc.complete_tick

        def complete(pending):
            aus = real_tick(pending)
            timings.append(dict(svc.last_timing))
            return aus

        svc.complete_tick = complete
        colorspace.launches = 0
        shas, ticks, _, _ = _drive_sessions(svc, bases)
        conv = colorspace.launches
        groups = [(g.lo, g.hi, str(g.device)) for g in svc.enc.groups]
        ref_devs = [str(g.ref[0].device) for g in svc.enc.groups]
        svc.close()
        bad = [t for t, (g, s) in enumerate(zip(shas, ses_shas)) if g != s]
        if bad:
            _fail(f"phase 21 (c): the grouped service's AUs differ from the one-card service's "
                  f"at ticks {bad}")
        want_ticks = [0] + [CARVE_GROUPS] * (SESSION_TICKS - 1)
        if ticks != want_ticks:
            _fail(f"phase 21 (c): K1 launches per tick {ticks}, want {want_ticks}")
        if conv != CARVE_GROUPS * SESSION_TICKS:
            _fail(f"phase 21 (c): bgrx_to_i420 launched {conv} times, want one per group "
                  f"and tick ({CARVE_GROUPS} x {SESSION_TICKS})")
        # ticks 1, 2 and 5 are all P (3 and 4 key some sessions)
        p_split = {k: statistics.median(timings[t][k] for t in (1, 2, 5)) for k in timings[1]}
        out["c_seconds"] = time.perf_counter() - t_part
        out["c"] = {"devices": how, "groups": groups, "reference_devices": ref_devs,
                    "me_mc_launches_per_tick": ticks, "colorspace_launches": conv,
                    "sha256": shas,
                    "p_tick_split_ms": p_split, "ticks": timings}
        print(f"phase 21 (c) TorchMultiSessionH264Service(8, {SW}, {SH}) in {CARVE_GROUPS} "
              f"groups on {how} {groups}: AUs sha256-equal phase 9's one-card service over "
              f"{SESSION_TICKS} ticks; K1 per tick {ticks}; bgrx_to_i420 {conv}; P tick split (median ms) "
              f"{json.dumps(p_split)}")
    finally:
        me_mc.me_mc_plain, me_mc.me_mc_batch_plain = real
    if any(plain.values()):
        _fail(f"phase 21: the plain versions ran on the card {plain}")
    out["plain_calls"] = plain
    out["me_mc_launches"] = {
        "bands_tiles": {k: sum(v["me_mc_launches"]) for k, v in out["a"].items()},
        "sessions": sum(out["c"]["me_mc_launches_per_tick"])}
    return out


def main() -> int:
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in native code prints every thread's stack

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from selkies_tpu_torch.models import frameprep
    from selkies_tpu_torch.models.h264 import intra, me_mc, native
    from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
    from selkies_tpu_torch.ops import colorspace
    from selkies_tpu_torch.utils.build import BUILD_DIR, nvcc

    timing = "--no-timing" not in sys.argv[1:]
    t_start = time.perf_counter()

    record: dict = {}
    # -- 1. the card
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    card, power_limit = (s.strip() for s in smi.split(",", 1))
    print(f"device: {kind} (count {count}); torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    record["card"] = {"name": card, "power_limit": power_limit, "kind": kind, "count": count}

    # -- 2. build the three libraries at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        futs = [pool.submit(f) for f in (me_mc.build, native.build, frameprep.build, intra.build,
                                         colorspace.build)]
        k_build, n_build, f_build, i_build, c_build = (f.result() for f in futs)
    record["build_s"] = {"me_mc": k_build.seconds, "native": n_build.seconds,
                         "frameprep": f_build.seconds, "intra": i_build.seconds,
                         "colorspace": c_build.seconds, "wall": time.perf_counter() - t0}
    print(f"build: me_mc {k_build.seconds:.2f} s, native {n_build.seconds:.2f} s, "
          f"frameprep {f_build.seconds:.2f} s, intra {i_build.seconds:.2f} s, "
          f"colorspace {c_build.seconds:.2f} s, wall {record['build_s']['wall']:.2f} s")
    print("intra ptxas:", i_build.log.strip() or "(cached build)")
    print("colorspace ptxas:", c_build.log.strip() or "(cached build)")
    if f_build.path.parent != BUILD_DIR or not f_build.path.exists():
        _fail(f"frameprep library {f_build.path} is not a build of native/frameprep.cc")
    print(f"frameprep: {f_build.path.relative_to(BUILD_DIR.parents[1])} "
          f"(g++ of native/frameprep.cc, {f_build.seconds:.2f} s)")
    print("me_mc ptxas:", k_build.log.strip() or "(cached build)")
    sass = _sass_check(k_build.path, nvcc())
    record["sass"] = sass
    print(f"me_mc SASS: VABSDIFF4 per kernel {sass['vabsdiff4_per_kernel']} "
          f"(native 4-way byte SAD: {sass['native_simd4']})")

    # -- 3. kernel against its plain version at 1920x1088
    cases = {"static": (1, (0, 0), 0), "uniform": (2, (-24, 29), 0),
             "near_reach_noise": (3, (33, -34), 12),
             # a tile with a 16-pixel halo: every |d| <= 14 (halo - 2)
             "tile_clamped": (4, (-20, 17), 6, (1088, 1920), {"dy_max": 14, "dx_max": 14}),
             # 86 MB columns: the last block holds a strip of 6 MBs
             "ragged_1376x768": (5, (9, -13), 6, (768, 1376))}
    # the band path's shapes at 4K (phase 8b): an interior tile of the 3x2
    # grid and the middle of 3 bands, each against its slab at the default
    # (full-reach) halos and clamped by 16-pixel halos; the whole frame
    # (bands=1 and the solo encoder)
    uhd = (2160, 3840)
    slab_cases = {
        "tile_720x1920": (6, (-24, 29), 6, uhd, (720, 1920, 720, 1920), (40, 40)),
        "tile_720x1920_clamped": (7, (-20, 17), 6, uhd, (720, 1920, 720, 1920), (16, 16)),
        "band_720x3840": (8, (33, -34), 12, uhd, (720, 0, 720, 3840), (40, 0)),
        "band_720x3840_clamped": (9, (-20, 17), 6, uhd, (720, 0, 720, 3840), (16, 0)),
        "frame_2160x3840": (10, (-24, 29), 6, uhd, (0, 0, 2160, 3840), (0, 0))}
    checks = [(n, _me_inputs, c) for n, c in cases.items()]
    checks += [(n, _slab_me_inputs, c) for n, c in slab_cases.items()]
    max_err = 0
    for name, make_inputs, case in checks:
        args = make_inputs(case, dev)
        got = me_mc.me_mc(*args)
        want = me_mc.me_mc_plain(*args)
        torch.cuda.synchronize()
        for out_name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
            err = int((a.long() - b.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                _fail(f"me_mc {name}: {out_name} differs from the plain version (max {err})")
        nz = int((got[0] != 0).any(-1).sum())
        h, w = args[1].shape
        print(f"me_mc check {name}: exact at {w}x{h}, reference {tuple(args[2].shape)} "
              f"({args[0].shape[0]} candidates, {nz} MBs with nonzero MV)")
        record.setdefault("me_mc_checks", {})[name] = {
            "cur": [h, w], "ref": list(args[2].shape), "candidates": args[0].shape[0],
            "nonzero_mv_mbs": nz}
    # the session axis: one launch over every session, each with its own
    # motion and candidate list (the multi-session tick's shapes)
    batch_cases = {"batch8_1088x1920": (8, 1088, 1920, 20), "batch3_768x1376": (3, 768, 1376, 30)}
    for name, (n, h, w, seed) in batch_cases.items():
        args = _batch_me_inputs(n, h, w, seed, dev)
        got = me_mc.me_mc_batch(*args)
        want = me_mc.me_mc_batch_plain(*args)
        torch.cuda.synchronize()
        for out_name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
            err = int((a.long() - b.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                _fail(f"me_mc_batch {name}: {out_name} differs from the plain version "
                      f"(max {err})")
        nz = [int((got[0][i] != 0).any(-1).sum()) for i in range(n)]
        print(f"me_mc_batch check {name}: exact, {n} sessions at {w}x{h} in one launch "
              f"({args[0].shape[1]} candidates each; MBs with nonzero MV per session {nz})")
        record.setdefault("me_mc_checks", {})[name] = {
            "sessions": n, "cur": [h, w], "candidates": args[0].shape[1],
            "nonzero_mv_mbs": nz}

    # the intra kernel at 1 and 8 sessions of 1088x1920
    record["intra_checks"] = _intra_phase(dev, timing=False)
    print("intra check: exact against the plain version at 1 and 8 x 1088x1920, one call each")
    record["colorspace_checks"] = _colorspace_phase(dev, timing=False)
    print("bgrx_to_i420 check: exact against the plain version at 8 x 1088x1920 and one frame, "
          "one launch each")

    # -- 4. the device-conversion path: the encoder at 1920x1080 on the card vs the CPU
    frames = _desktop_trace()
    flat = dict(pipeline_depth=0, frame_batch=1)  # one AU per submit
    enc = TorchH264Encoder(W, H, qp=28, host_convert=False, device="cuda", **flat)
    me_mc.launches = intra.launches = colorspace.launches = 0
    native.calls = 0
    t0 = time.perf_counter()
    gpu = _drive(enc, frames)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, packs, intra_launches = me_mc.launches, native.calls, intra.launches
    conv_launches = colorspace.launches
    t0 = time.perf_counter()
    cpu = _drive(TorchH264Encoder(W, H, qp=28, host_convert=False, device="cpu", **flat), frames)
    cpu_s = time.perf_counter() - t0
    for i, ((hg, sg), (hc, sc)) in enumerate(zip(gpu, cpu)):
        if hg != hc:
            _fail(f"frame {i}: cuda AU sha256 {hg[:16]} != cpu {hc[:16]}")
    p_frames = sum(1 for _, s in gpu if not s.idr and s.upload_kind != "static")
    if launches != p_frames:
        _fail(f"me_mc launched {launches} times for {p_frames} non-static P frames")
    if packs <= 0:
        _fail("the native packer never ran")
    idr_frames = sum(1 for _, s in gpu if s.idr)
    if intra_launches != idr_frames:
        _fail(f"intra launched {intra_launches} times for {idr_frames} IDR frames")
    # every frame that steps converts its upload on the card
    if conv_launches != idr_frames + p_frames:
        _fail(f"bgrx_to_i420 launched {conv_launches} times for {idr_frames + p_frames} "
              "frames that stepped")
    kinds = ["I" if s.idr else ("S" if s.upload_kind == "static" else "P") for _, s in gpu]
    print(f"encoder 1920x1080: {len(frames)} frames {''.join(kinds)}, AUs sha256-equal cuda vs cpu; "
          f"me_mc launches {launches} (= non-static P frames), bgrx_to_i420 launches "
          f"{conv_launches} (= I and non-static P frames), native packs {packs}; "
          f"bytes {[s.bytes for _, s in gpu]}; cuda run {main_s:.2f} s, cpu run {cpu_s:.2f} s")
    record["main_path"] = {"frames": "".join(kinds), "me_mc_launches": launches,
                           "intra_launches": intra_launches,
                           "colorspace_launches": conv_launches,
                           "native_packs": packs, "bytes": [s.bytes for _, s in gpu],
                           "sha256": [h for h, _ in gpu], "cuda_s": main_s, "cpu_s": cpu_s}

    # -- 5. the host-conversion path at 1920x1080 on the card vs the CPU
    trace = _host_trace()
    flat_host = dict(flat, ltr_scenes=False)
    henc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat_host)
    me_mc.launches = 0
    native.calls = native.sparse_calls = 0
    t0 = time.perf_counter()
    hgpu = _drive_host(henc, trace)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_launches, host_packs, host_sparse = me_mc.launches, native.calls, native.sparse_calls
    t0 = time.perf_counter()
    hcpu = _drive_host(TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cpu",
                                        **flat_host), trace)
    hcpu_s = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(hgpu, hcpu)):
        if g[0] != c[0]:
            _fail(f"host frame {i}: cuda AU sha256 {g[0][:16]} != cpu {c[0][:16]}")
        if (g[2], g[3], g[4]) != (c[2], c[3], c[4]):
            _fail(f"host frame {i}: cuda {g[2:]} != cpu {c[2:]}")
    hkinds = [r[2] for r in hgpu]
    if hkinds != [k for *_, k in trace]:
        _fail(f"host path frame kinds {hkinds} != {[k for *_, k in trace]}")
    if set(HOST_KINDS) - set(hkinds):
        _fail(f"host path missed kinds {set(HOST_KINDS) - set(hkinds)}")
    host_p = sum(1 for r in hgpu if not r[1].idr and r[1].upload_kind != "static")
    if host_launches != host_p:
        _fail(f"me_mc launched {host_launches} times for {host_p} non-static P frames (host path)")
    if host_sparse <= 0:
        _fail("the native sparse packer never ran on the host path")
    print(f"host path 1920x1080: {len(trace)} frames {hkinds}; AUs sha256-equal cuda vs cpu; "
          f"me_mc launches {host_launches} (= non-static P frames), native packs {host_packs} "
          f"(sparse {host_sparse}); bytes {[r[1].bytes for r in hgpu]}; up bytes "
          f"{[r[3] for r in hgpu]}; down bytes {[r[4] for r in hgpu]}; cuda run {host_s:.2f} s, "
          f"cpu run {hcpu_s:.2f} s")
    record["host_path"] = {
        "kinds": hkinds, "me_mc_launches": host_launches, "native_packs": host_packs,
        "native_sparse_packs": host_sparse, "bytes": [r[1].bytes for r in hgpu],
        "up_bytes": [r[3] for r in hgpu], "down_bytes": [r[4] for r in hgpu],
        "sha256": [r[0] for r in hgpu], "cuda_s": host_s, "cpu_s": hcpu_s,
        "frameprep_lib": str(f_build.path.name)}
    # -- 6. the registry row: groups of 4, pipeline depth 2, the LTR scene cache
    rtrace = _registry_trace()
    renc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda")
    me_mc.launches = 0
    native.calls = native.sparse_calls = 0
    t0 = time.perf_counter()
    rgpu, rups = _drive_registry(renc, rtrace)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    reg_launches, reg_sparse = me_mc.launches, native.sparse_calls
    groups, restores = dict(renc.group_sizes), renc.ltr_restores
    renc.close()
    t0 = time.perf_counter()
    rflat_enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat)
    rflat, _ = _drive_registry(rflat_enc, rtrace)
    flat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rcpu_enc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cpu")
    rcpu, rcpu_ups = _drive_registry(rcpu_enc, rtrace)
    rcpu_s = time.perf_counter() - t0
    rcpu_enc.close()
    for i, ((g, st), (c, _), (f, _)) in enumerate(zip(rgpu, rcpu, rflat)):
        if g != c:
            _fail(f"registry frame {i}: cuda AU sha256 {g[:16]} != cpu {c[:16]}")
        if g != f:
            _fail(f"registry frame {i}: grouped+pipelined AU {g[:16]} != flat card run {f[:16]}")
    if rups != rcpu_ups:
        _fail(f"registry path up bytes {rups} != cpu {rcpu_ups}")
    if restores < 2 or rcpu_enc.ltr_restores != restores or rflat_enc.ltr_restores != restores:
        _fail(f"ltr_restores {restores} (cpu {rcpu_enc.ltr_restores}, flat "
              f"{rflat_enc.ltr_restores}); want >= 2 and equal")
    if groups.get(4, 0) < 1 or groups.get(2, 0) < 1:
        _fail(f"registry path dispatched groups {groups}; want a 4 and a 2")
    reg_p = sum(1 for _, st in rgpu if not st.idr and st.upload_kind != "static")
    if reg_launches != reg_p:
        _fail(f"me_mc launched {reg_launches} times for {reg_p} non-static P frames (registry)")
    if reg_sparse <= 0:
        _fail("the native sparse packer never ran on the registry path")
    rkinds = "".join("I" if st.idr else {"static": "S", "full": "F", "delta": "D"}[st.upload_kind]
                     for _, st in rgpu)
    print(f"registry path 1920x1080 (frame_batch 4, pipeline_depth 2, ltr_scenes): "
          f"{len(rtrace)} frames {rkinds}; AUs sha256-equal to the cpu run and to the card run "
          f"with frame_batch=1, pipeline_depth=0; up bytes equal to the cpu run's {rups}; "
          f"ltr_restores {restores}; groups dispatched {groups}; me_mc launches {reg_launches} "
          f"(= non-static P frames); native sparse packs {reg_sparse}; qp "
          f"{[st.qp for _, st in rgpu]}; bytes {[st.bytes for _, st in rgpu]}; cuda run "
          f"{reg_s:.2f} s, flat card run {flat_s:.2f} s, cpu run {rcpu_s:.2f} s")
    record["registry_path"] = {
        "kinds": rkinds, "ltr_restores": restores, "group_sizes": groups,
        "me_mc_launches": reg_launches, "native_sparse_packs": reg_sparse, "up_bytes": rups,
        "bytes": [st.bytes for _, st in rgpu], "qp": [st.qp for _, st in rgpu],
        "sha256": [g for g, _ in rgpu], "cuda_s": reg_s, "flat_cuda_s": flat_s,
        "cpu_s": rcpu_s}

    # -- 7. the entropy plane: device CAVLC, host CABAC, device CABAC tokens
    etrace = _entropy_trace()
    de = dict(device_entropy=True, bits_min_mbs=64)
    t0 = time.perf_counter()
    native.cabac_calls = 0

    def row_enc(dev, **kw):
        return TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device=dev, **kw)

    ref_rows, ref_ans, ref_k1, ref_ltr = _drive_entropy(row_enc("cuda"), etrace, {"device_entropy": False})
    a_rows, a_ans, a_k1, a_ltr = _drive_entropy(row_enc("cuda", **de), etrace, {"device_entropy": False})
    b_rows, b_ans, b_k1, b_ltr = _drive_entropy(row_enc("cuda", entropy_coder="cabac"), etrace,
                                         {"entropy_coder": "cavlc"})
    c_rows, c_ans, c_k1, c_ltr = _drive_entropy(row_enc("cuda", entropy_coder="cabac", **de), etrace,
                                         {"entropy_coder": "cavlc"})
    dtrace = etrace[:2] + etrace[3:5] + etrace[8:9]  # ends with the (refused) switch
    flat_d = dict(flat, host_convert=False, entropy_coder="cabac")
    d_rows, d_ans, d_k1, d_ltr = _drive_entropy(row_enc("cuda", **flat_d), dtrace,
                                         {"entropy_coder": "cavlc"})
    cabac_engine = native.cabac_calls
    ent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_cpu, *_ = _drive_entropy(row_enc("cpu", entropy_coder="cabac"), etrace,
                                 {"entropy_coder": "cavlc"})
    d_cpu, *_ = _drive_entropy(row_enc("cpu", **flat_d), dtrace, {"entropy_coder": "cavlc"})
    ent_cpu_s = time.perf_counter() - t0
    shas = {k: [h for h, _ in r] for k, r in (("ref", ref_rows), ("a", a_rows), ("b", b_rows),
                                              ("c", c_rows), ("d", d_rows), ("b_cpu", b_cpu),
                                              ("d_cpu", d_cpu))}
    for x, y in (("a", "ref"), ("c", "b"), ("b", "b_cpu"), ("d", "d_cpu")):
        bad = [i for i, (p, q) in enumerate(zip(shas[x], shas[y])) if p != q]
        if bad or len(shas[x]) != len(shas[y]):
            _fail(f"entropy path: ({x}) AUs differ from ({y}) at frames {bad}")
    modes = {k: [st.downlink_mode for _, st in r] for k, r in (
        ("a", a_rows), ("b", b_rows), ("c", c_rows), ("d", d_rows))}
    # frames 1 and 2 are the quiet typed lines; 3 the scene cut, 4 and 5
    # the busy scrolls
    for k, coded in (("a", "bits"), ("c", "cabac"), ("b", "coeff")):
        if modes[k][1:3] != ["coeff"] * 2 or modes[k][3:6] != [coded] * 3:
            _fail(f"entropy path ({k}): downlink modes {modes[k]}")
    if (a_ans, ref_ans, b_ans, c_ans, d_ans) != (True, False, True, True, False):
        _fail(f"retune answers a {a_ans} ref {ref_ans} b {b_ans} c {c_ans} d {d_ans}")
    if not (b_rows[8][1].idr and c_rows[8][1].idr) or a_rows[8][1].idr:
        _fail("the coder switch must force an IDR in (b) and (c), and nothing in (a)")
    if cabac_engine <= 0:
        _fail("the native CABAC engine never ran")
    if min(ref_ltr, a_ltr, b_ltr, c_ltr) < 1:
        _fail(f"entropy path: LTR restores ref {ref_ltr} a {a_ltr} b {b_ltr} c {c_ltr}")
    idr_pack = {"cabac_host_ms": b_rows[0][1].pack_ms, "cavlc_ms": ref_rows[0][1].pack_ms,
                "cabac_bytes": b_rows[0][1].bytes, "cavlc_bytes": ref_rows[0][1].bytes}
    ekinds = "".join("I" if st.idr else {"static": "S", "full": "F", "delta": "D"}[st.upload_kind]
                     for _, st in a_rows)
    print(f"entropy path 1920x1080 (registry row; {len(etrace)} frames {ekinds}): (a) device "
          f"CAVLC AUs equal the row's own CAVLC AUs, (c) device CABAC tokens equal (b) host "
          f"CABAC, (b) and (d) device conversion CABAC equal their cpu runs; modes "
          f"{json.dumps(modes)}; me_mc launches a {a_k1} b {b_k1} c {c_k1} d {d_k1} ref {ref_k1} "
          f"(= non-static P frames); native CABAC engine runs {cabac_engine}; ltr_restores "
          f"{[ref_ltr, a_ltr, b_ltr, c_ltr]}; IDR pack {json.dumps(idr_pack)}; bytes cavlc "
          f"{[st.bytes for _, st in a_rows]} cabac {[st.bytes for _, st in c_rows]}; cuda runs "
          f"{ent_s:.2f} s, cpu runs {ent_cpu_s:.2f} s")
    record["entropy_path"] = {
        "kinds": ekinds, "modes": modes, "sha256": shas, "idr_pack": idr_pack,
        "me_mc_launches": {"a": a_k1, "b": b_k1, "c": c_k1, "d": d_k1, "ref": ref_k1},
        "cabac_engine_runs": cabac_engine, "bytes": {
            k: [st.bytes for _, st in r] for k, r in (("a", a_rows), ("c", c_rows))},
        "cuda_s": ent_s, "cpu_s": ent_cpu_s}
    # -- 8. band and tile slicing: 1080p against the CPU, 4K on the card alone
    from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

    btrace, ltrace = _band_trace(), _band_trace(light=True)
    band_cfgs = {"bands4": (dict(bands=4), btrace),
                 "bands4_cols2": (dict(bands=4, cols=2), btrace),
                 "cabac_device_bands4": (dict(bands=4, entropy_coder="cabac",
                                              device_entropy=True, bits_min_mbs=64), ltrace)}
    band_rec: dict = {}
    band_launches, band_p = {}, {}
    t0 = time.perf_counter()
    for name, (kw, tr) in band_cfgs.items():
        benc = TorchBandedH264Encoder(W, H, qp=28, device="cuda", **kw)
        me_mc.launches = 0
        tc = time.perf_counter()
        bgpu, per_frame = _drive_band(benc, tr)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - tc
        launched = me_mc.launches
        benc.close()
        tc = time.perf_counter()
        cpu_enc = TorchBandedH264Encoder(W, H, qp=28, device="cpu", **kw)
        bcpu, _ = _drive_band(cpu_enc, tr)
        cpu_enc.close()
        cpu_s = time.perf_counter() - tc
        bad = [i for i, ((g, _), (c, _)) in enumerate(zip(bgpu, bcpu)) if g != c]
        if bad:
            _fail(f"band path {name}: cuda AUs differ from the cpu run's at frames {bad}")
        tiles = benc.bands * benc.cols
        if (benc.bands, benc.cols) != (4, kw.get("cols", 1)):
            _fail(f"band path {name}: carve {benc.bands}x{benc.cols}")
        want = [0 if st.idr or st.upload_kind == "static" else tiles for _, st in bgpu]
        if per_frame != want or launched != sum(want):
            _fail(f"band path {name}: me_mc launches {per_frame}, want {want}")
        band_launches[name], band_p[name] = launched, _p_frames(bgpu)
        band_rec[name] = {
            "carve": f"{benc.bands}x{benc.cols}", "me_mc_launches": launched,
            "launches_per_frame": per_frame, "bytes": [st.bytes for _, st in bgpu],
            "modes": [st.downlink_mode for _, st in bgpu],
            "kinds": "".join("I" if st.idr else "S" if st.upload_kind == "static" else "P"
                             for _, st in bgpu),
            "sha256": [h for h, _ in bgpu], "cuda_s": cuda_s, "cpu_s": cpu_s}
    if "cabac" not in band_rec["cabac_device_bands4"]["modes"]:
        _fail(f"band path: no CABAC band shipped device tokens "
              f"{band_rec['cabac_device_bands4']['modes']}")
    # 4K on the card alone: the grid against its band oracle, one band
    # against the solo encoder
    k4 = _band_trace(3840, 2160)[:6]
    k4_runs = {}
    for name, make in (
            ("grid3x2", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=3, cols=2,
                                                       device="cuda")),
            ("bands3", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=3,
                                                      device="cuda")),
            ("bands1", lambda: TorchBandedH264Encoder(3840, 2160, qp=28, bands=1,
                                                      device="cuda")),
            ("solo", lambda: TorchH264Encoder(3840, 2160, qp=28, frame_batch=1,
                                              pipeline_depth=0, ltr_scenes=False,
                                              scene_qp_boost=0, device="cuda"))):
        kenc = make()
        me_mc.launches = 0
        tc = time.perf_counter()
        rows, per_frame = _drive_band(kenc, k4)
        torch.cuda.synchronize()
        k4_runs[name] = {"sha256": [h for h, _ in rows], "bytes": [st.bytes for _, st in rows],
                         "launches_per_frame": per_frame, "cuda_s": time.perf_counter() - tc,
                         "carve": f"{getattr(kenc, 'bands', 1)}x{getattr(kenc, 'cols', 1)}"}
        kenc.close()
    for x, y in (("grid3x2", "bands3"), ("bands1", "solo")):
        bad = [i for i, (p, q) in enumerate(zip(k4_runs[x]["sha256"], k4_runs[y]["sha256"]))
               if p != q]
        if bad:
            _fail(f"4K: {x} AUs differ from {y} at frames {bad}")
    if k4_runs["grid3x2"]["carve"] != "3x2" or max(k4_runs["grid3x2"]["launches_per_frame"]) != 6:
        _fail(f"4K grid: carve {k4_runs['grid3x2']['carve']}, launches "
              f"{k4_runs['grid3x2']['launches_per_frame']}")
    k4_enc = TorchBandedH264Encoder(3840, 2160, bands=4, device="cuda")
    k4_bands4 = (k4_enc.bands, k4_enc.cols)
    k4_enc.close()
    if k4_bands4 != (3, 1):
        _fail(f"4K bands=4 resolved to {k4_bands4}, not 3 bands (135 MB rows)")
    band_s = time.perf_counter() - t0
    print(f"band path 1920x1080 ({len(btrace)} frames {band_rec['bands4']['kinds']}): bands4, "
          f"bands4_cols2 and cabac_device_bands4 AUs sha256-equal cuda vs cpu; me_mc launches "
          f"{band_launches} (= bands x cols per non-static P frame); modes "
          f"{json.dumps({k: v['modes'] for k, v in band_rec.items()})}; bytes "
          f"{json.dumps({k: v['bytes'] for k, v in band_rec.items()})}; 4K 3840x2160: grid "
          f"3x2 = bands 3, bands 1 = solo encoder, bands=4 -> {k4_bands4[0]} bands, bytes "
          f"{k4_runs['grid3x2']['bytes']}; launches grid3x2 "
          f"{k4_runs['grid3x2']['launches_per_frame']}; {band_s:.1f} s")
    record["band_path"] = {"1080p": band_rec, "4k": k4_runs, "4k_bands4": k4_bands4,
                           "seconds": band_s}
    # -- 9. multi-session serving: 8 x 1920x1088 against solo card encoders,
    # 4 x 640x368 against the CPU run
    from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service

    t0 = time.perf_counter()
    bases = [_session_base(i, SW, SH) for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    svc = TorchMultiSessionH264Service(8, SW, SH, qp=28, device="cuda")
    me_mc.launches = intra.launches = colorspace.launches = 0
    ses_shas, ses_ticks, ses_qps, ses_forced = _drive_sessions(svc, bases)
    torch.cuda.synchronize()
    ses_launches, ses_intra, ses_conv = me_mc.launches, intra.launches, colorspace.launches
    # one group on one card: one conversion a tick, P, IDR and mixed alike
    if ses_conv != SESSION_TICKS:
        _fail(f"sessions: bgrx_to_i420 launched {ses_conv} times in {SESSION_TICKS} ticks")
    idr_ticks = sum(1 for t in range(SESSION_TICKS)
                    if t == 0 or any(t in f for f in ses_forced.values()))
    if ses_intra != idr_ticks:
        _fail(f"sessions: intra launched {ses_intra} times for {idr_ticks} ticks with an IDR")
    ses_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    svc.close()
    ses_s = time.perf_counter() - t0
    # K1 once per tick with a P session: every tick after the first here
    want_ticks = [0] + [1] * (SESSION_TICKS - 1)
    if ses_ticks != want_ticks or ses_launches != sum(want_ticks):
        _fail(f"sessions: me_mc launches per tick {ses_ticks}, want {want_ticks}")
    t0 = time.perf_counter()
    for i, base in enumerate(bases):
        solo = TorchH264Encoder(SW, SH, qp=28, host_convert=False, frame_batch=1,
                                pipeline_depth=0, device="cuda")
        for t in range(SESSION_TICKS):
            if t in ses_forced[i]:
                solo.force_keyframe()
            au = solo.encode_frame(_session_frame(base, i, t), qp=ses_qps[i][t])
            if hashlib.sha256(au).hexdigest() != ses_shas[t][i]:
                _fail(f"sessions: session {i} tick {t} differs from its solo card encoder")
        solo.close()
    solo_s = time.perf_counter() - t0
    small_bases = [_session_base(i, 640, 368) for i in range(4)]
    small = {}
    for dev_name in ("cuda", "cpu"):
        ssvc = TorchMultiSessionH264Service(4, 640, 368, qp=28, device=dev_name)
        me_mc.launches = colorspace.launches = 0
        tc = time.perf_counter()
        small[dev_name] = _drive_sessions(ssvc, small_bases) + (
            me_mc.launches, time.perf_counter() - tc, colorspace.launches)
        ssvc.close()
    if small["cuda"][0] != small["cpu"][0]:
        bad = [t for t, (g, c) in enumerate(zip(small["cuda"][0], small["cpu"][0])) if g != c]
        _fail(f"sessions 4 x 640x368: cuda AUs differ from the cpu run's at ticks {bad}")
    if small["cuda"][4] != SESSION_TICKS - 1:
        _fail(f"sessions 4 x 640x368: me_mc launched {small['cuda'][4]} times")
    if small["cuda"][6] != SESSION_TICKS or small["cpu"][6]:
        _fail(f"sessions 4 x 640x368: bgrx_to_i420 launched {small['cuda'][6]} times on the "
              f"card and {small['cpu'][6]} on the CPU in {SESSION_TICKS} ticks")
    idr_map = ["".join("I" if t == 0 or t in ses_forced[i] else "P" for i in range(8))
               for t in range(SESSION_TICKS)]
    print(f"multi-session 8 x {SW}x{SH} ({SESSION_TICKS} ticks, per tick {idr_map}): every "
          f"session's AUs sha256-equal its solo card encoder's; me_mc launches per tick "
          f"{ses_ticks} (once per tick with a P session), bgrx_to_i420 launches {ses_conv} "
          f"(once a tick); peak device memory "
          f"{ses_peak_mb:.0f} MiB; service {ses_s:.1f} s, solo encoders {solo_s:.1f} s; "
          f"4 x 640x368 cuda AUs equal the cpu run's (me_mc launches {small['cuda'][4]}; "
          f"cuda {small['cuda'][5]:.1f} s, cpu {small['cpu'][5]:.1f} s)")
    record["session_path"] = {
        "ticks": idr_map, "me_mc_launches": ses_launches, "launches_per_tick": ses_ticks,
        "intra_launches": ses_intra, "colorspace_launches": ses_conv,
        "qps": ses_qps, "forced": ses_forced, "sha256": ses_shas, "peak_device_mb": ses_peak_mb,
        "cuda_s": ses_s, "solo_s": solo_s,
        "small_640x368": {"sha256": small["cuda"][0], "me_mc_launches": small["cuda"][4],
                          "colorspace_launches": small["cuda"][6],
                          "cuda_s": small["cuda"][5], "cpu_s": small["cpu"][5]}}
    # -- 12. the hybrid VP9/AV1 rows and the registry
    t0 = time.perf_counter()
    record["hybrid_path"] = _hybrid_phase()
    record["hybrid_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {record['hybrid_path']['seconds']:.1f} s")
    # -- 13. the health and observability plane
    t0 = time.perf_counter()
    record["observability_path"] = _observability_phase(
        record["band_path"]["1080p"]["bands4"]["sha256"])
    record["observability_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {record['observability_path']['seconds']:.1f} s")
    # -- 14. the fleet's banded service, lifecycle and occupancy scheduler
    t0 = time.perf_counter()
    record["fleet_path"] = _fleet_phase()
    record["fleet_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 14: {record['fleet_path']['seconds']:.1f} s")
    # -- 15. the tile-column codec mesh, the library rows, the software fleet
    t0 = time.perf_counter()
    record["mesh_path"] = _mesh_phase()
    record["mesh_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 15: {record['mesh_path']['seconds']:.1f} s")
    # -- 16. the solo serving app (its timing, (d), only with the timing)
    t0 = time.perf_counter()
    record["app_path"] = _app_phase(timing)
    record["app_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 16: {record['app_path']['seconds']:.1f} s")
    # -- 17. the fleet's serving core: SessionFleet's tick loop on the card
    t0 = time.perf_counter()
    record["fleet_loop_path"] = _fleet_loop_phase()
    record["fleet_loop_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 17: {record['fleet_loop_path']['seconds']:.1f} s")
    # -- 18. the solo server: Orchestrator in process, then python -m selkies_tpu_torch
    t0 = time.perf_counter()
    record["server_path"] = _server_phase()
    record["server_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {record['server_path']['seconds']:.1f} s")
    # -- 19. the solo server over WebRTC: a clean link, then a lossy one
    record["webrtc_path"] = _webrtc_phase()
    print(f"phase 19: {record['webrtc_path']['seconds']:.1f} s")
    # -- 20. the fleet server (--tpu_sessions 8) and two cluster hosts
    t0 = time.perf_counter()
    loop_runs = [r["fps"] for r in record["fleet_loop_path"]["b"]["runs"]
                 if r["occupancy"] == "1"]
    record["fleet_server_path"] = _fleet_server_phase(
        loop_fps=statistics.median(loop_runs) if loop_runs else None)
    record["fleet_server_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {record['fleet_server_path']['seconds']:.1f} s")
    # -- 21. the multi-card carve: band, tile, column and session meshes
    t0 = time.perf_counter()
    record["carve_path"] = _carve_phase(timing, ses_shas)
    record["carve_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 21: {record['carve_path']['seconds']:.1f} s")
    print(f"phases 1-9 and 12-21: {time.perf_counter() - t_start:.1f} s")
    if not timing:
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    # -- 10. timing
    # seconds of each timing block, in order
    block_s: dict = {}
    t_block = time.perf_counter()
    args = _me_inputs(cases["uniform"], dev)
    ms = _time_cuda(lambda: me_mc.me_mc(*args), iters=50, hold=True)
    issued_ms = _time_cuda(lambda: me_mc.me_mc(*args), iters=50)
    # one candidate: the same loads and stores, ~1/76 of the SADs
    one_ms = _time_cuda(lambda: me_mc.me_mc(args[0][:1], *args[1:]), iters=50, hold=True)
    plain_ms = _time_cuda(lambda: me_mc.me_mc_plain(*args), iters=5, warmup=1)
    cands, cur, ry, ru, rv = args
    ncand, (h, w) = cands.shape[0], cur.shape
    out_bytes = (h // 16) * (w // 16) * 2 * 4 + h * w * 4 + 2 * (h // 2) * (w // 2) * 4
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    # one absolute difference per pixel and candidate; the kernel does four
    # at a time where the SASS shows the native instruction (VABSDIFF4)
    ops = ncand * h * w
    simd_ops = ops // 4 if sass["native_simd4"] else ops
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    simd_ms = simd_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, simd_ms)
    print(f"me_mc {ncand} cands x {w}x{h}: {ms:.5f} ms (CUDA events, 50 launches queued "
          f"behind a spin kernel; {issued_ms:.5f} ms as the host issues them; {one_ms:.5f} ms "
          f"for 1 candidate), plain "
          f"{plain_ms:.3f} ms; floors: bytes {bytes_ms:.5f} ms, operations {simd_ms:.5f} ms "
          f"({'one VABSDIFF4 per 4 pixels' if sass['native_simd4'] else 'one per pixel'}); "
          f"bound {bound_ms:.5f} ms = {100 * bound_ms / ms:.1f}% of the kernel's time")

    def per_frame(idr: bool, n: int, warmup: int = 2):
        """Median FrameStats split over n frames: forced IDRs of frame 0,
        or P frames alternating between two scroll positions."""
        rows = []
        launches0 = me_mc.launches
        for i in range(warmup + n):
            if idr:
                enc.force_keyframe()
            (_, s, _), = enc.submit(frames[0] if idr else frames[1 + i % 2])
            if s.idr != idr or s.upload_kind == "static":
                _fail(f"timing frame {i} has the wrong kind")
            rows.append(s)
        out = {k: statistics.median(getattr(s, k) for s in rows[warmup:])
               for k in ("device_ms", "upload_ms", "step_ms", "fetch_ms", "pack_ms", "bytes")}
        out["me_mc_launches_per_frame"] = (me_mc.launches - launches0) / len(rows)
        return out

    enc_t = {"idr": per_frame(True, 3), "p": per_frame(False, 20)}
    record["encoder_ms"] = enc_t
    print("device-conversion encoder per frame (median ms): " + json.dumps(enc_t))

    # the host-conversion encoder: median FrameStats split per frame kind
    tenc = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda", **flat_host)
    rounds = _drive_host(tenc, _host_timing_trace(3))[12:]  # the first round warms up
    split = {}
    for kind_name in sorted({r[2] for r in rounds}):
        rows = [r for r in rounds if r[2] == kind_name]
        med = {k: statistics.median(getattr(r[1], k) for r in rows) for k in (
            "classify_ms", "convert_ms", "h2d_ms", "upload_ms", "step_ms", "fetch_ms",
            "unpack_ms", "cavlc_ms", "device_ms", "pack_ms", "bytes")}
        med.update(frames=len(rows), up_bytes=statistics.median(r[3] for r in rows),
                   down_bytes=statistics.median(r[4] for r in rows))
        split[kind_name] = med
    record["host_encoder_ms"] = split
    print("host-conversion encoder per frame kind (median ms, bytes): " + json.dumps(split))
    prof = {"idr": _profile_frames(enc, frames, True, 1),
            "p": _profile_frames(enc, frames, False, 5),
            "delta_p": _profile_host_deltas(tenc, 8)}
    record["profile"] = prof
    print("profile (torch.profiler, profiler on): " + json.dumps(prof))

    block_s["kernel_encoder_host"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the registry row against ungrouped, unpipelined, and each knob alone,
    # one after another, on a typing run
    typing = _typing_run(40, 300)
    cfgs = {"registry": {}, "flat": flat, "batch4_depth0": {"pipeline_depth": 0},
            "batch1_depth2": {"frame_batch": 1}}
    typing_t = {name: [] for name in cfgs}
    for name in cfgs:
        typing_t[name].append(_time_typing(cfgs[name], typing, warm=8))
    record["typing_run"] = typing_t
    print(f"1080p typing run, 32 deltas after an IDR and 8 warm-up deltas, submitted back to "
          f"back ({card}, {power_limit}): " + json.dumps(typing_t))
    preg = TorchH264Encoder(W, H, qp=28, scene_qp_boost=BOOST, device="cuda")
    prof_reg = _profile_host_deltas(preg, 8)
    prof_reg["group_sizes"] = dict(preg.group_sizes)
    preg.close()
    record["profile"]["delta_p_registry"] = prof_reg
    print(f"profile of 8 grouped typing deltas, registry row ({card}, {power_limit}): "
          + json.dumps(prof_reg))
    block_s["typing"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the registry row with the tracer and telemetry off and on, in turns
    hooks_t = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        hooks_t[name].append(_time_typing({}, typing, warm=8, hooks=name == "on"))
    from selkies_tpu_torch.resilience.devhealth import _default_probe

    probe_ms = []
    for _ in range(51):
        tp = time.perf_counter()
        _default_probe(dev)
        probe_ms.append((time.perf_counter() - tp) * 1e3)
    hooks_t["site_us"] = _hook_site_us()
    hooks_t["probe_ms_median"] = statistics.median(probe_ms[1:])
    hooks_t["probe_ms_p95"] = sorted(probe_ms[1:])[-(-95 * 50 // 100) - 1]
    record["hooks_timing"] = hooks_t
    print(f"hooks off / on, registry row 1080p typing run, in turns off-on-on-off ({card}, "
          f"{power_limit}): " + json.dumps({
              k: [{m: r[m] for m in ("fps", "latency_ms_median", "latency_ms_p95")
                   if m in r} for r in v] for k, v in hooks_t.items() if isinstance(v, list)})
          + f"; span medians (ms) {json.dumps(hooks_t['on'][0]['span_median_ms'])}; probe "
          f"{hooks_t['probe_ms_median']:.4f} ms median, {hooks_t['probe_ms_p95']:.4f} p95 "
          f"(of 50); one hook site's host cost in us {json.dumps(hooks_t['site_us'])}")

    block_s["hooks"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the entropy plane: per coder, device entropy off and on
    ent_t = {f"{coder}_{'device' if on else 'host'}": _time_entropy(coder, on)
             for coder in ("cavlc", "cabac") for on in (False, True)}
    ent_t["downlink"] = _time_entropy_downlink(dev)
    # an IDR of the phase-5 desktop (a wallpaper dotted with glyph noise):
    # the host coders' pack time, CABAC (Python per MB) against CAVLC (C++)
    noisy = _host_frames(2027)[0]
    for coder in ("cavlc", "cabac"):
        ienc = TorchH264Encoder(W, H, qp=28, device="cuda", entropy_coder=coder, **flat_host)
        (_, st, _), = ienc.submit(noisy)
        ienc.close()
        ent_t[f"idr_{coder}"] = {k: getattr(st, k) for k in (
            "step_ms", "unpack_ms", "cavlc_ms", "pack_ms", "bytes")}
    record["entropy_timing"] = ent_t
    print(f"entropy plane at 1080p ({card}, {power_limit}): " + json.dumps(ent_t))

    block_s["entropy"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # band and tile slicing against the flat solo encoder: 1080p full motion
    # (10 scrolls), and the 4K grid
    scrolls = _scroll_run(W, H, 10)
    band_t = {}
    for name, make in (
            # no tile cache: full motion is full P frames, as in the banded path
            ("solo_flat", lambda: TorchH264Encoder(W, H, qp=28, device="cuda", tile_cache=0,
                                                   **flat_host)),
            ("bands4", lambda: TorchBandedH264Encoder(W, H, qp=28, bands=4, device="cuda")),
            ("grid2x2", lambda: TorchBandedH264Encoder(W, H, qp=28, bands=2, cols=2,
                                                       device="cuda"))):
        benc = make()
        band_t[name] = _time_band_split(benc, scrolls)
        if name != "grid2x2":
            band_t[name]["profile_p"] = _profile_frames(
                benc, scrolls, False, 4, feed=lambda i: scrolls[3 + i % 2])
        benc.close()
    k4enc = TorchBandedH264Encoder(3840, 2160, qp=28, bands=3, cols=2, device="cuda")
    band_t["4k_grid3x2"] = _time_band_split(k4enc, _scroll_run(3840, 2160, 6))
    k4enc.close()
    record["band_timing"] = band_t
    print(f"band and tile slicing, 1080p full motion and 4K ({card}, {power_limit}): "
          + json.dumps(band_t))

    block_s["bands"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # multi-session serving at 1, 2, 4 and 8 sessions of 1920x1088 on full
    # motion, then the same frames through 8 solo flat encoders in turn
    ses_t = {f"n{n}": _time_sessions(n, p_ticks=4, prof_ticks=2) for n in (1, 2, 4, 8)}
    ses_t["solo8_in_turn"] = _time_solo_in_turn(8)
    tick_ops = {k: ses_t[k]["profile_p"].get("device_ops_per_tick") for k in ("n1", "n8")}
    if None in tick_ops.values():
        _fail(f"the profiler counted no device ops for a session P tick: {tick_ops}")
    ses_t["device_ops_ratio_8_to_1"] = tick_ops["n8"] / tick_ops["n1"]
    if tick_ops["n8"] > 1.25 * tick_ops["n1"]:
        _fail(f"an 8-session P tick issues {tick_ops['n8']} device ops, more than 1.25x the "
              f"1-session tick's {tick_ops['n1']}")
    # the batched kernel alone at 8 sessions of 1088x1920
    args8 = _batch_me_inputs(8, 1088, 1920, 20, dev)
    b_ms = _time_cuda(lambda: me_mc.me_mc_batch(*args8), iters=20, hold=True)
    b_issued_ms = _time_cuda(lambda: me_mc.me_mc_batch(*args8), iters=20)
    b_plain_ms = _time_cuda(lambda: me_mc.me_mc_batch_plain(*args8), iters=2, warmup=1)
    b_cands, b_cur = args8[0], args8[1]
    bn, (bh, bw), bk = b_cur.shape[0], b_cur.shape[1:], b_cands.shape[1]
    b_out_bytes = bn * ((bh // 16) * (bw // 16) * 2 * 4 + bh * bw * 4 + 2 * (bh // 2) * (bw // 2) * 4)
    b_bytes = sum(t.numel() * t.element_size() for t in args8) + b_out_bytes
    b_ops = bn * bk * bh * bw
    b_simd_ops = b_ops // 4 if sass["native_simd4"] else b_ops
    b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
    b_simd_ms = b_simd_ops / INT32_OPS_PER_S * 1e3
    b_bound_ms = max(b_bytes_ms, b_simd_ms)
    ses_t["me_mc_batch8"] = {"ms": b_ms, "host_issued_ms": b_issued_ms, "plain_ms": b_plain_ms,
                             "bound_ms": b_bound_ms, "bytes": b_bytes}
    record["session_timing"] = ses_t
    print(f"multi-session serving, 1920x1088 full motion ({card}, {power_limit}): "
          + json.dumps(ses_t))
    print(f"me_mc_batch 8 sessions x {bk} cands x {bw}x{bh}: {b_ms:.5f} ms (CUDA events, 20 "
          f"launches queued behind a spin kernel; {b_issued_ms:.5f} ms as issued), plain "
          f"{b_plain_ms:.3f} ms; floors: bytes {b_bytes_ms:.5f} ms, operations {b_simd_ms:.5f} "
          f"ms; bound {b_bound_ms:.5f} ms = {100 * b_bound_ms / b_ms:.1f}% of the kernel's time")

    intra_t = _intra_phase(dev, timing=True)
    record["intra_timing"] = intra_t
    print(f"intra kernel at 1088x1920 ({card}, {power_limit}): " + json.dumps(intra_t))
    conv_t = _colorspace_phase(dev, timing=True)
    record["colorspace_timing"] = conv_t
    print(f"bgrx_to_i420 kernel at 1088x1920 ({card}, {power_limit}): " + json.dumps(conv_t))

    block_s["sessions"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the hybrid rows' front-end and rows, per frame kind
    hyb_t = _time_hybrid(card, power_limit)
    record["hybrid_timing"] = hyb_t
    print(f"hybrid VP9/AV1 front-end and rows at 1920x1080 ({card}, {power_limit}): "
          + json.dumps(hyb_t))

    block_s["hybrid"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the fleet: phase 14's (a) and (c) configurations, occupancy off and on
    fleet_t = _time_fleet(card, power_limit, pairs=1)
    record["fleet_timing"] = fleet_t
    print(f"fleet service and occupancy scheduler, full motion ({card}, {power_limit}): "
          + json.dumps(fleet_t))

    block_s["fleet"], t_block = time.perf_counter() - t_block, time.perf_counter()
    # the mesh front-end against the solo one, and the software fleet
    t0 = time.perf_counter()
    mesh_t = _time_mesh(card, power_limit)
    mesh_t["seconds"] = time.perf_counter() - t0
    # phase 15 (d)'s service: its IDR tick and 6 more P ticks of full motion
    mesh_t["software_fleet"] = record["mesh_path"]["software_fleet"]["timing"]
    record["mesh_timing"] = mesh_t
    print(f"mesh front-end and software fleet at {W}x{H} ({card}, {power_limit}): "
          + json.dumps(mesh_t))

    block_s["mesh"], t_block = time.perf_counter() - t_block, time.perf_counter()
    kernels = [{
        "name": "me_mc", "route": "cuda", "source": "selkies_tpu_torch/csrc/me_mc.cu",
        "replaces": me_mc.REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if simd_ms >= bytes_ms else "bytes", "library_ms": None,
        "design": "v2", "shape": f"{ncand} cands x {h}x{w}", "bytes": nbytes,
        "int32_ops": ops, "simd_ops": simd_ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "ops_ms_simd": simd_ms, "sass_vabsdiff4_native": sass["native_simd4"],
        "host_issued_ms": issued_ms, "one_cand_ms": one_ms,
        "bound_share": bound_ms / ms,
        "launches_per_p_frame": launches / p_frames, "launches_host_path": host_launches,
        "launches_per_p_frame_host_path": host_launches / host_p,
        "launches_registry_path": reg_launches,
        "launches_per_p_frame_registry_path": reg_launches / reg_p,
        "launches_entropy_path": a_k1 + b_k1 + c_k1 + d_k1,
        "launches_entropy_path_per_run": {"a": a_k1, "b": b_k1, "c": c_k1, "d": d_k1},
        "launches_band_path": sum(band_launches.values()),
        "launches_per_p_frame_band_path": {k: band_launches[k] / band_p[k]
                                           for k in band_launches},
        "launches_band_path_per_run": band_launches,
        "launches_session_path": ses_launches,
        "launches_per_tick_session_path": ses_ticks,
        "launches_tpuh264enc_registry_path": record["hybrid_path"]["tpuh264enc"]["me_mc_launches"],
        "launches_observability_path_hooks_on": record["observability_path"]["a"][
            "me_mc_launches"],
        "launches_fleet_path": {
            "banded_serial_640x384": record["fleet_path"]["a"]["me_mc_launches"]["serial_small"],
            "banded_occupancy": record["fleet_path"]["a"]["me_mc_launches"]["occupancy"],
            "mixed_off": record["fleet_path"]["c"]["me_mc_launches"]["off"],
            "mixed_on": record["fleet_path"]["c"]["me_mc_launches"]["on"]},
        "launches_per_tick_fleet_path": {
            "banded_4x1080_bands2": record["fleet_path"]["a"]["launches_per_tick"]["occupancy"],
            "mixed_4batch_2banded": record["fleet_path"]["c"]["launches_per_tick"]["on"]},
        "launches_library_degrade_path": record["mesh_path"]["library_launches"],
        "launches_library_degrade_path_per_row": {
            k: v["me_mc_launches"] for k, v in record["mesh_path"]["library_rows"].items()
            if "degrade" in v},
        "launches_software_fleet_path": record["mesh_path"]["software_fleet"]["me_mc_launches"],
        "launches_per_tick_software_fleet_path":
            record["mesh_path"]["software_fleet"]["launches_per_tick"],
        "launches_fleet_codec_path": record["mesh_path"]["fleet_codecs"]["me_mc_launches"],
        "launches_app_path": {
            "registry_row": record["app_path"]["a"]["me_mc_launches"],
            "ladder": [s["me_mc_launches"] for s in record["app_path"]["b"]["stages"]],
            "policy_slo": record["app_path"]["c"]["me_mc_launches"]},
        "launches_per_p_frame_app_path": record["app_path"]["a"]["me_mc_launches"]
        / record["app_path"]["a"]["p_frames"],
        "launches_fleet_loop_path": {
            "ticks_8x1088": record["fleet_loop_path"]["a"]["me_mc_launches"],
            "live_runs": [r["me_mc_launches_run"] for r in record["fleet_loop_path"]["b"]["runs"]],
            "banded_4x1080": record["fleet_loop_path"]["c"]["me_mc_launches"],
            "ladder": [s["me_mc_launches"] for s in record["fleet_loop_path"]["d"]["stages"]],
            "dryrun_8": record["fleet_loop_path"]["e"]["me_mc_launches"]},
        "launches_per_tick_fleet_loop_path": {
            "batch_8x1088": record["fleet_loop_path"]["a"]["launches_per_tick"],
            "banded_4x1080_bands2": record["fleet_loop_path"]["c"]["launches_per_tick"]},
        "launches_server_path": record["server_path"]["a"]["me_mc_launches"],
        "launches_per_p_frame_server_path": record["server_path"]["a"]["me_mc_launches"]
        / record["server_path"]["a"]["p_frames"],
        "p_frames_sent_server_path": record["server_path"]["a"]["p_frames_sent"],
        "launches_webrtc_path": record["webrtc_path"]["me_mc_launches"],
        "launches_per_p_frame_webrtc_path": record["webrtc_path"]["k1_session_launches"]
        / record["webrtc_path"]["p_frames"],
        "launches_fleet_server_path": record["fleet_server_path"]["a"]["me_mc_launches"],
        "ticks_with_p_fleet_server_path": record["fleet_server_path"]["a"]["ticks_with_p"],
        "plain_calls_fleet_server_path": record["fleet_server_path"]["a"]["me_mc_plain_calls"],
        "launches_cluster_path": record["fleet_server_path"]["b"]["me_mc_launches"],
        "launches_carve_path": record["carve_path"]["me_mc_launches"],
        "launches_per_p_frame_carve_path": {
            k: max(v["me_mc_launches"]) for k, v in record["carve_path"]["a"].items()},
        "launches_per_tick_carve_sessions": record["carve_path"]["c"]["me_mc_launches_per_tick"],
        "plain_calls_carve_path": record["carve_path"]["plain_calls"],
        "card": card, "power_limit": power_limit,
    }, {
        "name": "me_mc (8 sessions, one launch)", "route": "cuda",
        "source": "selkies_tpu_torch/csrc/me_mc.cu", "replaces": me_mc.REPLACES,
        "launches": ses_launches, "max_abs_err": max_err, "ms": b_ms, "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms, "bound_by": "operations" if b_simd_ms >= b_bytes_ms else "bytes",
        "library_ms": None, "shape": f"{bn} sessions x {bk} cands x {bh}x{bw}",
        "bytes": b_bytes, "simd_ops": b_simd_ops, "bytes_ms": b_bytes_ms,
        "ops_ms_simd": b_simd_ms, "host_issued_ms": b_issued_ms, "bound_share": b_bound_ms / b_ms,
        "launches_per_tick": ses_ticks, "card": card, "power_limit": power_limit,
    }] + [{
        "name": f"intra ({row['sessions']} session{'s' if row['sessions'] > 1 else ''})",
        "route": "cuda", "source": "selkies_tpu_torch/csrc/intra.cu",
        "replaces": intra.REPLACES, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bytes_ms"], "bound_by": "bytes; the serial chain sets the time",
        "library_ms": None, "shape": f"{row['sessions']} x 1088x1920", "bytes": row["bytes"],
        "chain_steps": row["chain_steps"], "us_per_chain_step": row["us_per_chain_step"],
        "host_issued_ms": row["host_issued_ms"], "bound_share": row["bytes_ms"] / row["ms"],
        "launches_main_path": intra_launches, "launches_session_path": ses_intra,
        "card": card, "power_limit": power_limit,
    } for row in (intra_t["n1"], intra_t["n8"])] + [{
        "name": f"bgrx_to_i420 ({name})", "route": "cuda",
        "source": "selkies_tpu_torch/csrc/colorspace.cu", "replaces": colorspace.REPLACES,
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": row["shape"], "bytes": row["bytes"],
        "host_issued_ms": row["host_issued_ms"], "bound_share": row["bound_share"],
        "launches_main_path": conv_launches, "launches_session_path": ses_conv,
        "launches_fleet_server_path": record["fleet_server_path"]["a"]["colorspace_launches"],
        "launches_carve_sessions": record["carve_path"]["c"]["colorspace_launches"],
        "card": card, "power_limit": power_limit,
    } for name, row in conv_t.items()]
    record["kernels"] = kernels
    record["timing_seconds"] = block_s
    print("timing blocks (s): " + json.dumps(block_s))
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
