"""Caption-bubble video renderer (+ optional TTS hook).

A copy of the JAX package's streaming_vlm_tpu/demo/render.py (it runs no
model): PIL draws the bubbles, the port's native FFmpeg encoder
(video/native/svt_ingest.cc `svt_encoder_*`, `video.ingest.VideoWriter`)
writes the mp4, and TTS is gated on the synthesiser being installed
(`synth_speech` and `kokoro_synth` raise with instructions instead of
stubbing silently). PIL, kokoro and soundfile are imported where used.
"""

from __future__ import annotations

import textwrap
from typing import Dict, List, Optional, Sequence, Tuple


_CHAR_W = 7  # px per character of PIL's default bitmap font


def _bubble_layout(text: str, width_px: int, char_w: int = _CHAR_W) -> List[str]:
    cols = max(10, (width_px - 40) // char_w)
    return textwrap.wrap(text, cols)[:3]


def draw_bubble(frame, text: str, *, margin: int = 8):
    """Draw one rounded caption bubble onto an RGB uint8 frame (in place on a
    copy). Returns the new frame."""
    import numpy as np
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame)
    d = ImageDraw.Draw(img, "RGBA")
    w, h = img.size
    lines = _bubble_layout(text, w)
    if not lines:
        return frame
    line_h = 12
    pad = 6
    bh = len(lines) * line_h + 2 * pad
    bw = min(w - 2 * margin, max(len(l) for l in lines) * _CHAR_W + 2 * pad)
    x0, y0 = margin, h - margin - bh
    d.rounded_rectangle(
        [x0, y0, x0 + bw, y0 + bh], radius=8, fill=(34, 170, 102, 220)
    )
    for i, line in enumerate(lines):
        d.text((x0 + pad, y0 + pad + i * line_h), line, fill=(255, 255, 255, 255))
    return np.asarray(img)


def render_caption_video(
    video_path: str,
    segments: Sequence[Dict],  # [{"start","end","text"}]
    out_path: str,
    *,
    fps: int = 10,
    max_seconds: Optional[float] = None,
    synth=None,  # callable(text) -> mono float32 PCM at audio_rate; None = no audio
    audio_rate: int = 24000,
) -> Tuple[int, int]:
    """Burn caption bubbles into the video: each frame shows the segment
    active at its timestamp. With `synth`, each segment's speech is placed
    at its start time on an AAC audio track muxed by the native encoder
    (pass `synth=kokoro_synth` when kokoro is installed, or any fake synth
    in tests). Returns (n_frames, n_segments_drawn)."""
    import numpy as np

    from ..video.ingest import VideoReader, VideoWriter

    r = VideoReader(video_path)
    ts = r.frame_ts[:, 1]  # per-source-frame end seconds
    total = float(ts[-1]) if len(ts) else 0.0
    if max_seconds is not None:
        total = min(total, max_seconds)
    # resample BY TIMESTAMP onto the output fps grid: writing every source
    # frame at `fps` would stretch/compress any source whose native rate
    # differs (30 fps source at fps=10 played 3x slow, bubbles and TTS
    # landing at the wrong playback moments). Output frame j shows the
    # source frame live at t = j/fps, so output duration == source
    # duration and the audio offsets below line up by construction.
    n = max(int(total * fps), 1)
    w = r.width - r.width % 4
    h = r.height - r.height % 4
    drawn = set()
    with VideoWriter(
        out_path, w, h, fps, audio_rate=audio_rate if synth else 0
    ) as out:
        for j in range(n):
            t = j / fps
            i = max(int(np.searchsorted(ts, t, side="right")), 0)
            frame = r.fetch([min(i, len(ts) - 1)], w, h)[0]
            for si, seg in enumerate(segments):
                if seg["start"] <= t < seg["end"] and seg["text"]:
                    frame = draw_bubble(frame, seg["text"])
                    drawn.add(si)
                    break
            out.write(frame)
        if synth is not None:
            duration = n / fps
            track = np.zeros(int(duration * audio_rate) + 1, np.float32)
            for seg in segments:
                if not seg["text"] or seg["start"] >= duration:
                    continue
                pcm = np.asarray(synth(seg["text"]), np.float32).reshape(-1)
                o = int(seg["start"] * audio_rate)
                m = min(len(pcm), len(track) - o)
                if m > 0:
                    track[o : o + m] += pcm[:m]
            out.write_audio(np.clip(track, -1.0, 1.0))
    return n, len(drawn)


def kokoro_synth(text: str):
    """synth callable for render_caption_video backed by kokoro TTS. Raises
    with install instructions when the package is missing."""
    try:
        from kokoro import KPipeline  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "TTS requires the 'kokoro' package (pip install kokoro); "
            "caption rendering works without it (synth=None)."
        ) from e
    import numpy as np

    pipe = KPipeline(lang_code="a")
    return np.concatenate([audio for _, _, audio in pipe(text, voice="af_heart")])


def synth_speech(text: str, out_wav: str) -> str:
    """TTS hook (kokoro). Raises with install instructions when no
    synthesiser is available."""
    try:
        from kokoro import KPipeline  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "TTS requires the 'kokoro' package (pip install kokoro soundfile); "
            "it is not part of this image. Caption rendering works without it "
            "via render_caption_video."
        ) from e
    import numpy as np
    import soundfile as sf  # type: ignore

    pipe = KPipeline(lang_code="a")
    chunks = [audio for _, _, audio in pipe(text, voice="af_heart")]
    sf.write(out_wav, np.concatenate(chunks), 24000)
    return out_wav
