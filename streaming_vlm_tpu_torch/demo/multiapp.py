"""Multi-client live-caption serving over HTTP: N videos -> N concurrent
live SSE commentary streams, all batched on one card.

Port of streaming_vlm_tpu/demo/multiapp.py over the port's
`MultiStreamServer` and `MultiStreamEngine`: every viewer's chunks batch
into shared rounds (on the card: one K1 lane-form launch a layer for the
round's prefill, one K2 or K3 lane-form launch a layer a decode step, K5
for a W8A8 model's products), amortising each weight read across all of
them. `mesh=` serves the lanes on a mesh of ranks (parallel/: TP over
'model', lanes over 'data'); run the same app on every rank (torchrun),
each lane fed from the same video on every rank; only rank 0 serves HTTP.

Endpoints:
  * GET /            - dashboard: a grid of every stream, each a <video> +
                       live caption bubbles driven by its own EventSource
  * GET /stream/<i>  - single-stream player page
  * GET /video/<i>   - source file i (Range-aware so <video> can seek)
  * GET /events/<i>  - SSE stream of {"start","end","text"} segments for
                       stream i; replays history, so late viewers catch up

Run: python -m streaming_vlm_tpu_torch demo --video_path a.mp4 b.mp4 ...
(one lane per video; mixed resolutions are fine: each lane encodes at its
own grid).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ModelConfig, SamplingConfig, StreamConfig, VideoConfig
from ..serve import DEFAULT_QUERY
from .app import SegmentFeed as _Feed  # shared with the single-stream demo
from ..streaming.multiserve import MultiStreamServer
from ..streaming.multistream import MultiStreamEngine
from ..streaming.protocol import PromptBuilder, build_round_segs, hf_encode_fn

DASHBOARD = """<!DOCTYPE html>
<html><head><title>streaming-vlm-tpu multi-stream demo</title><style>
body { font-family: sans-serif; background: #111; color: #eee; margin: 1em; }
#grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(380px, 1fr));
  gap: 1em; }
.cell { background: #181818; border-radius: 8px; padding: .7em; }
.cell h3 { margin: .1em 0 .4em; font-size: 1em; color: #9fc; }
video { width: 100%; border-radius: 6px; }
.caps { margin-top: .5em; min-height: 5em; }
.bubble { background: #2a6; color: #fff; border-radius: 12px;
  padding: .35em .7em; margin: .25em 0; font-size: .85em; opacity: 0;
  transition: opacity .3s; }
.bubble.live { opacity: 1; }
.t { color: #9fc; font-size: .8em; margin-right: .5em; }
</style></head><body>
<h2>StreamingVLM (TPU) — __N__ live streams, one chip</h2>
<div id="grid"></div>
<script>
const N = __N__;
const grid = document.getElementById('grid');
for (let i = 0; i < N; i++) {
  const cell = document.createElement('div');
  cell.className = 'cell';
  cell.innerHTML = '<h3><a href="/stream/' + i + '">stream ' + i + '</a></h3>' +
    '<video src="/video/' + i + '" controls autoplay muted></video>' +
    '<div class="caps" id="caps' + i + '"></div>';
  grid.appendChild(cell);
  const caps = cell.querySelector('.caps');
  const v = cell.querySelector('video');
  const pending = [];
  const es = new EventSource('/events/' + i);
  es.onmessage = (e) => { pending.push(JSON.parse(e.data)); };
  es.onerror = () => { es.close(); };
  setInterval(() => {
    while (pending.length && pending[0].start <= v.currentTime + 0.05) {
      const seg = pending.shift();
      const d = document.createElement('div');
      d.className = 'bubble';
      const t = document.createElement('span');
      t.className = 't';
      t.textContent = seg.start.toFixed(1) + 's';
      d.appendChild(t);
      // textContent, never innerHTML: captions are MODEL OUTPUT
      d.appendChild(document.createTextNode(seg.text));
      caps.prepend(d);
      requestAnimationFrame(() => d.classList.add('live'));
      while (caps.children.length > 4) caps.removeChild(caps.lastChild);
    }
  }, 100);
}
</script></body></html>"""


class MultiLiveCaptionServer:
    """N videos -> N live caption streams batched on one card.

    One feeder thread per video ingests chunks (C++ decode -> patchify) and
    submits them to a shared MultiStreamServer; the server's round thread
    batches whichever lanes have a chunk ready into one round. Feeders run
    flat-out by default (as fast as the card serves them);
    `realtime=True` paces each feeder to the video clock — what a live
    camera feed would look like."""

    def __init__(
        self,
        cfg: ModelConfig,
        model,
        tokenizer,
        video_paths: Sequence[str],
        *,
        stream: Optional[StreamConfig] = None,
        sampling: Optional[SamplingConfig] = None,
        video: Optional[VideoConfig] = None,
        queries: Optional[Sequence[str]] = None,
        previous_text: str = "",
        duration: Optional[float] = None,
        realtime: bool = False,
        host: str = "127.0.0.1",
        port: int = 7860,
        dtype=None,
        mesh=None,
    ):
        assert len(video_paths) >= 1
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.video_paths = list(video_paths)
        self.n = len(video_paths)
        self.stream = stream or StreamConfig()
        self.sampling = sampling or SamplingConfig()
        self.video = video or VideoConfig(fps=self.stream.fps)
        self.queries = list(queries) if queries else [DEFAULT_QUERY] * self.n
        assert len(self.queries) == self.n
        self.previous_text = previous_text
        self.duration = duration
        self.realtime = realtime
        self.feeds = [_Feed() for _ in range(self.n)]

        self.engine = MultiStreamEngine(
            cfg, model, self.stream, self.sampling, self.n,
            dtype=dtype or model.text.embed.weight.dtype, mesh=mesh,
        )
        if hasattr(tokenizer, "convert_tokens_to_ids"):  # HF tokenizer
            encode = hf_encode_fn(tokenizer)
        else:  # any callable text -> List[int] (e.g. FakeTokenizer)
            encode = tokenizer
        self.builder = PromptBuilder(cfg.tokens, encode)
        _, end_bias = self.builder.measure_biases()
        self.server = MultiStreamServer(self.engine, end_bias=end_bias)
        self._threads: List[threading.Thread] = []
        # under a mesh of several ranks only rank 0 answers HTTP
        rank0 = self.engine.mesh is None or self.engine.mesh.rank == 0
        self.httpd = (_make_httpd(self.n, self.video_paths, self.feeds, host, port)
                      if rank0 else None)

    @property
    def port(self) -> Optional[int]:
        return None if self.httpd is None else self.httpd.server_address[1]

    # ---------------------------------------------------------------- feeders
    def _decode_text(self, ids: np.ndarray) -> str:
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode(
                [int(t) for t in ids], skip_special_tokens=True
            )
        return " ".join(str(int(t)) for t in ids)

    def _feed_stream(self, i: int) -> None:
        """Ingest video i chunk by chunk through the shared server."""
        import time as _time

        from ..video.ingest import ChunkedVideoSource

        st = self.stream
        feed = self.feeds[i]
        client = None
        try:
            src = ChunkedVideoSource(
                self.video_paths[i],
                fps=st.fps,
                max_pixels=self.video.max_pixels_for_window(st.window_size),
                min_pixels=self.video.video_min_pixels,
                patch_size=self.cfg.vision.patch_size,
                temporal_patch_size=self.cfg.vision.temporal_patch_size,
                merge_size=self.cfg.vision.spatial_merge_size,
            )
            total = src.duration
            if self.duration is not None:
                total = min(total, self.duration)
            num_chunks = int((total + st.chunk_duration - 1) // st.chunk_duration)
            client = self.server.attach(seed=self.sampling.seed + 1000 + i, key=i)
            t_wall0 = _time.perf_counter()
            for c in range(num_chunks):
                start = c * st.chunk_duration
                patches, grid, _ = src.read_chunk(start, start + st.chunk_duration)
                if self.realtime:
                    # live-camera pacing: chunk c's frames only exist at
                    # wall time (c+1) * chunk_duration
                    lag = (start + st.chunk_duration) - (
                        _time.perf_counter() - t_wall0
                    )
                    if lag > 0:
                        _time.sleep(lag)
                segs = build_round_segs(
                    self.builder, st, self.cfg.vision.spatial_merge_size,
                    c, start,
                    grid, query=self.queries[i],
                    previous_text=self.previous_text,
                )
                client.submit(segs, pixel_patches=patches, grid_thw=grid)
                _idx, gen = client.get(timeout=600.0)
                response = self._decode_text(gen)
                clean = response[:-4] if response.endswith(" ...") else response
                feed.push(
                    {
                        "start": float(start),
                        "end": float(start + st.chunk_duration),
                        "text": clean,
                    }
                )
        finally:
            # close in the finally: a feeder that dies mid-stream (ingest
            # error, get() timeout, rejected chunk)
            # must free its lane for other clients — lanes are only ever
            # released by close(). close() is idempotent.
            if client is not None:
                client.close()
            feed.finish()

    # ------------------------------------------------------------------- run
    def _start_workers(self) -> None:
        """Start the round scheduler + one feeder per video, exactly once
        (idempotent: start_background for warmup followed by serve_forever
        must not spawn a second set of feeders submitting duplicate
        chunks)."""
        if self._threads:
            return
        self.server.start()
        for i in range(self.n):
            t = threading.Thread(target=self._feed_stream, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def start_background(self) -> None:
        """Start the round scheduler, one feeder per video, and (rank 0) the
        HTTP server — all on daemon threads."""
        self._start_workers()
        if self.httpd is not None:
            threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every feeder finished its video. True if all done."""
        import time as _time

        deadline = None if timeout is None else _time.perf_counter() + timeout
        for t in self._threads:
            left = None if deadline is None else max(0.0, deadline - _time.perf_counter())
            t.join(timeout=left)
        return all(not t.is_alive() for t in self._threads)

    def serve_forever(self) -> None:
        """Rank 0 (or no mesh): serve HTTP until interrupted. Another rank:
        run its feeders to their end, then its round loop until rank 0
        stops."""
        if self.httpd is None:
            self._start_workers()
            self.wait()
            self.server.stop()
            return
        print(
            f"multi-stream demo ({self.n} lanes): "
            f"http://{self.httpd.server_address[0]}:{self.port}/"
        )
        self._start_workers()
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.server.stop()


def _make_httpd(n: int, video_paths: Sequence[str], feeds: Sequence[_Feed], host: str,
                port: int):
    """The dashboard's HTTP server over lanes 0..n-1. It is given what it
    serves, not the MultiLiveCaptionServer: its handler class is freed only
    by the cycle collector, and must not keep the engine and its model alive
    after the server is dropped."""
    import re
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .app import PAGE, serve_file_range, serve_sse

    def parse_idx(path: str, prefix: str) -> Optional[int]:
        m = re.match(rf"{prefix}/(\d+)$", path)
        if not m:
            return None
        i = int(m.group(1))
        return i if i < n else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _html(self, body: str) -> None:
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._html(DASHBOARD.replace("__N__", str(n)))
                return
            i = parse_idx(self.path, "/stream")
            if i is not None:
                # single-stream player: the single-stream demo page with
                # this lane's endpoints substituted in
                self._html(
                    PAGE.replace("/video", f"/video/{i}").replace(
                        "/events", f"/events/{i}"
                    )
                )
                return
            i = parse_idx(self.path, "/video")
            if i is not None:
                self._serve_video(video_paths[i])
                return
            i = parse_idx(self.path, "/events")
            if i is not None:
                self._serve_events(feeds[i])
                return
            self.send_response(404)
            self.end_headers()

        def _serve_video(self, path: str) -> None:
            serve_file_range(self, path)

        def _serve_events(self, feed: _Feed) -> None:
            serve_sse(self, feed.subscribe())

    return ThreadingHTTPServer((host, port), Handler)
