"""Live streaming-caption demo app.

Port of streaming_vlm_tpu/demo/app.py: a dependency-free stdlib HTTP
server

  * GET /        - player page: <video> + live caption bubbles driven by
                   Server-Sent Events, synced to video.currentTime
  * GET /video   - the source file (Range-aware so the <video> tag can seek)
  * GET /events  - SSE stream of {"start","end","text"} segments produced
                   live by the streaming engine

and `stream_segments`, the live segment source over the port's
`StreamingSession` (on the card: K1 for each chunk's prefill, K2 or K3 for
its decode steps, K5 for a W8A8 model's products). `PAGE` is the JAX
package's page, byte for byte.

Run: python -m streaming_vlm_tpu_torch demo --model_path ... --video_path ...
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Optional

PAGE = """<!DOCTYPE html>
<html><head><title>streaming-vlm-tpu live demo</title><style>
body { font-family: sans-serif; background: #111; color: #eee; margin: 2em; }
#wrap { max-width: 860px; margin: auto; }
video { width: 100%; border-radius: 8px; }
#caps { margin-top: 1em; min-height: 8em; }
.bubble { background: #2a6; color: #fff; border-radius: 14px;
  padding: .5em .9em; margin: .3em 0; max-width: 80%; opacity: 0;
  transition: opacity .3s; }
.bubble.live { opacity: 1; }
.t { color: #9fc; font-size: .8em; margin-right: .6em; }
</style></head><body><div id="wrap">
<h2>StreamingVLM (TPU) — live commentary</h2>
<video id="v" src="/video" controls autoplay muted></video>
<div id="caps"></div>
<script>
const caps = document.getElementById('caps');
const v = document.getElementById('v');
const pending = [];
const es = new EventSource('/events');
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
    // textContent, never innerHTML: captions are MODEL OUTPUT — markup
    // characters in them must render as text, not parse as HTML
    d.appendChild(document.createTextNode(seg.text));
    caps.prepend(d);
    requestAnimationFrame(() => d.classList.add('live'));
    while (caps.children.length > 6) caps.removeChild(caps.lastChild);
  }
}, 100);
</script></div></body></html>"""

SegmentSource = Callable[[], Iterator[Dict]]


class SegmentFeed:
    """Append-only segment feed with replay: each SSE subscriber iterates
    from the start and blocks for new items until the producer finishes.
    ONE producer fans out to any number of connections — an EventSource
    auto-reconnect or a second viewer must replay the same generation, not
    start a duplicate one on the card."""

    def __init__(self):
        self.items: list = []
        self.done = False
        self.cond = threading.Condition()

    def push(self, seg: Dict) -> None:
        with self.cond:
            self.items.append(seg)
            self.cond.notify_all()

    def finish(self) -> None:
        with self.cond:
            self.done = True
            self.cond.notify_all()

    def subscribe(self) -> Iterator[Dict]:
        i = 0
        while True:
            with self.cond:
                while i >= len(self.items) and not self.done:
                    self.cond.wait(timeout=1.0)
                if i >= len(self.items):
                    if self.done:
                        return
                    continue
                seg = self.items[i]
            i += 1
            yield seg


def serve_file_range(h: BaseHTTPRequestHandler, path: str,
                     content_type: str = "video/mp4") -> None:
    """Range-aware file endpoint (RFC 7233 single ranges): <video> seeking
    needs bytes=START-, bytes=START-END, and the SUFFIX form bytes=-N (mp4
    players probe the trailing moov atom with it). Unsatisfiable ranges get
    416 + 'bytes */size' instead of a negative Content-Length. Shared by the
    single-stream and multi-stream demo handlers."""
    size = os.path.getsize(path)
    rng = h.headers.get("Range")
    start, end = 0, size - 1
    if rng:
        m = re.match(r"bytes=(\d*)-(\d*)", rng)
        if m and (m.group(1) or m.group(2)):
            if m.group(1):
                start = int(m.group(1))
                if m.group(2):
                    end = min(int(m.group(2)), size - 1)
            else:
                # suffix range: the LAST N bytes
                start = max(0, size - int(m.group(2)))
        else:
            rng = None  # malformed: ignore and serve the whole file
        if rng and (start >= size or end < start):
            h.send_response(416)
            h.send_header("Content-Range", f"bytes */{size}")
            h.send_header("Content-Length", "0")
            h.end_headers()
            return
    n = end - start + 1
    h.send_response(206 if rng else 200)
    h.send_header("Content-Type", content_type)
    h.send_header("Accept-Ranges", "bytes")
    if rng:
        h.send_header("Content-Range", f"bytes {start}-{end}/{size}")
    h.send_header("Content-Length", str(n))
    h.end_headers()
    with open(path, "rb") as f:
        f.seek(start)
        remaining = n
        while remaining > 0:
            chunk = f.read(min(1 << 20, remaining))
            if not chunk:
                break
            try:
                h.wfile.write(chunk)
            except (BrokenPipeError, ConnectionResetError):
                return
            remaining -= len(chunk)


def serve_sse(h: BaseHTTPRequestHandler, segments: Iterator[Dict]) -> None:
    """Server-Sent Events endpoint: one `data:` frame per segment, then a
    terminal `done` event. Shared by both demo handlers."""
    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Cache-Control", "no-cache")
    h.end_headers()
    try:
        for seg in segments:
            h.wfile.write(
                f"data: {json.dumps(seg, ensure_ascii=False)}\n\n".encode()
            )
            h.wfile.flush()
        h.wfile.write(b"event: done\ndata: {}\n\n")
        h.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        pass


class LiveCaptionServer:
    """Serve one video + a live SSE caption stream."""

    def __init__(
        self,
        video_path: str,
        segment_source: SegmentSource,
        host: str = "127.0.0.1",
        port: int = 7860,
    ):
        self.video_path = video_path
        self.segment_source = segment_source

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/video"):
                    serve_file_range(self, self.server.video_path)
                elif self.path.startswith("/events"):
                    serve_sse(self, self.server.segment_source())
                else:
                    self.send_response(404)
                    self.end_headers()

        # what the handler serves rides the HTTP server (`self.server`), not
        # a closure over this object: a class is freed only by the cycle
        # collector, and one closing over this object would keep the caption
        # source (an engine and its model) alive after the server is dropped
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.video_path, self.httpd.segment_source = video_path, segment_source

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    # ------------------------------------------------------------------- run
    def serve_forever(self):
        print(f"demo: http://{self.httpd.server_address[0]}:{self.port}/")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def stream_segments(
    *,
    cfg,
    model,
    tokenizer,
    video_path: str,
    stream=None,
    sampling=None,
    video=None,
    query: str = "Commentate on this match",
    previous_text: str = "",
    duration: Optional[float] = None,
    dtype=None,
) -> Iterator[Dict]:
    """Incremental segment generator over a video: the demo's live source.
    Mirrors serve.streaming_inference's chunk loop (pipelined dispatch) but
    yields each segment as soon as it is decoded."""
    from ..config import StreamConfig, VideoConfig
    from ..serve import StreamingSession
    from ..video.ingest import ChunkedVideoSource

    stream = stream or StreamConfig()
    video = video or VideoConfig(fps=stream.fps)
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling,
        previous_text=previous_text, query=query, dtype=dtype,
    )
    src = ChunkedVideoSource(
        video_path,
        fps=stream.fps,
        max_pixels=video.max_pixels_for_window(stream.window_size),
        min_pixels=video.video_min_pixels,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size,
    )
    total = duration if duration is not None else src.duration
    num_chunks = int((total + stream.chunk_duration - 1) // stream.chunk_duration)
    nxt = src.read_chunk(0.0, stream.chunk_duration) if num_chunks else None
    embeds = None
    for i in range(num_chunks):
        patches, grid, _ = nxt
        start = i * stream.chunk_duration
        handle = session.run_chunk_async(
            i, start,
            pixel_patches=None if embeds is not None else patches,
            vis_embeds=embeds, grid_thw=grid,
        )
        embeds = None
        if i + 1 < num_chunks:
            s = (i + 1) * stream.chunk_duration
            nxt = src.read_chunk(s, s + stream.chunk_duration)
            embeds = session.encode_patches(nxt[0], nxt[1])
        response, _ = session.finish_chunk(i, handle)
        clean = response[:-4] if response.endswith(" ...") else response
        yield {
            "start": float(start),
            "end": float(start + stream.chunk_duration),
            "text": clean,
        }
