"""Prompt/protocol builder: byte-exact Qwen chat-template assembly, split into
segments for the streaming table.

A copy of streaming_vlm_tpu/streaming/protocol.py over the port's segment
table, held bitwise equal to it by tests/test_torch_host.py.

The reference builds round-0 prompts with apply_chat_template and later rounds
as '\\n' + template[SYSTEM_PROMPT_OFFSET:] (inference.py:370-388); the trailing
"\\n"-vs-<|im_end|> edge is handled at :397-406. Here each turn is rendered as
one string, tokenized ONCE (so BPE merges match the reference, which tokenizes
whole prompt strings), then split into structural segments at special-token
boundaries.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SpecialTokens
from .segments import (
    ASST_OPEN,
    PREV_BODY,
    PREV_FOOTER,
    PREV_HEADER,
    QUERY,
    SEP,
    SEP_AFTER_ASST,
    SEP_AFTER_USER,
    SYSTEM,
    Seg,
    USER_CLOSE,
    USER_OPEN,
    USER_TIME,
    VIS_CLOSE,
    VIS_OPEN,
    VISION,
)

DEFAULT_SYSTEM = "You are a helpful assistant."

EncodeFn = Callable[[str], List[int]]


class PromptBuilder:
    """Build per-round segment lists. `encode` must map special-token literals
    (<|im_start|> etc.) to their single ids, like a HF tokenizer with
    special-token parsing enabled."""

    def __init__(self, tokens: SpecialTokens, encode: EncodeFn):
        self.tok = tokens
        self.encode = encode

    # ------------------------------------------------------------------ helpers
    def _ids(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), np.int32)

    def measure_biases(self) -> Tuple[int, int]:
        """(assistant_start_bias, assistant_end_bias) — token counts of
        '<|im_start|>assistant\\n' and ' ...<|im_end|>', measured with the live
        tokenizer exactly like the reference (inference.py:228-229)."""
        return (
            len(self.encode("<|im_start|>assistant\n")),
            len(self.encode(" ...<|im_end|>")),
        )

    # ------------------------------------------------------------------ turns
    def system_segment(self, system_text: str = DEFAULT_SYSTEM) -> Seg:
        return Seg(SYSTEM, self._ids(f"<|im_start|>system\n{system_text}<|im_end|>"))

    def previous_text_segments(self, previous_text: str) -> List[Seg]:
        """previous-text turn: header / body / footer. Rendered as one string
        then split so BPE merges across the header boundary match."""
        full = self._ids(f"\n<|im_start|>previous text\n{previous_text}<|im_end|>")
        # header = \n <|im_start|> previous(2 tokens) \n  -> 5 tokens
        # (the reference's 4-token header excludes the separator \n, which it
        # attributes to the preceding segment; we attach it to the header)
        hdr = 5
        assert full[1] == self.tok.im_start and full[hdr - 1] == self.tok.newline
        assert full[-1] == self.tok.im_end
        return [
            Seg(PREV_HEADER, full[:hdr]),
            Seg(PREV_BODY, full[hdr:-1]),
            Seg(PREV_FOOTER, full[-1:]),
        ]

    def time_prompt(self, start: float, end: float) -> str:
        return f"Time={start:.1f}-{end:.1f}s"

    def user_turn_segments(
        self,
        rnd: int,
        start: float,
        end: float,
        n_video_tokens: int,
        grid_thw: Tuple[int, int, int],
        second_per_grid_t: float,
        query: Optional[str] = None,
        *,
        question: str = "",
        prepend_newline: bool = True,
    ) -> List[Seg]:
        """One streaming user turn:
        \\n<|im_start|>user\\nTime=a-bs{question}<|vision_start|>[pads]<|vision_end|>{query}<|im_end|>
        tokenized as one string, split at special-token boundaries.

        `question` is a mid-stream qa_stream injection placed right after the
        Time text, in the TRAINING layout: round 0 concatenates it directly
        ('Time=...s{q}', reference lmm_dataset.py:242-244); later rounds are
        'Time=...s {q}' with the space ALWAYS present — trailing even when
        the question is empty (reference :281). NOTE a deliberate divergence
        from the reference here: its own inference feeds bare 'Time=...s'
        prompts (inference.py:352,373), token-drifting from what the
        checkpoint was trained on; this framework keeps serve == train
        byte-for-byte (tests/test_serve.py qa token-alignment), because a
        different token instance is a different KV. `query` is the round-0
        task prompt placed after the vision block (inference.py:370-377)."""
        lead = "\n" if prepend_newline else ""
        qtext = query or ""
        qsep = " " if rnd > 0 else ""
        text = (
            f"{lead}<|im_start|>user\n{self.time_prompt(start, end)}{qsep}{question}"
            f"<|vision_start|>{'<|video_pad|>' * n_video_tokens}<|vision_end|>"
            f"{qtext}<|im_end|>"
        )
        ids = self._ids(text)
        t = self.tok
        vs = int(np.nonzero(ids == t.vision_start)[0][0])
        ve = int(np.nonzero(ids == t.vision_end)[0][0])
        segs = []
        if prepend_newline:
            # the separator \n belongs to the PRECEDING assistant turn
            # (round rnd-1); for round 0 it follows the never-pruned
            # previous-text turn
            sep_kind = SEP_AFTER_ASST if rnd > 0 else SEP
            segs.append(Seg(sep_kind, ids[:1], round=rnd - 1))
            ids = ids[1:]
            vs -= 1
            ve -= 1
        hdr = 3
        assert ids[hdr - 1] == t.newline and ids[-1] == t.im_end
        segs += [
            Seg(USER_OPEN, ids[:hdr], round=rnd),
            Seg(USER_TIME, ids[hdr:vs], round=rnd),
            Seg(VIS_OPEN, ids[vs : vs + 1], round=rnd),
            Seg(
                VISION,
                ids[vs + 1 : ve],
                round=rnd,
                grid_thw=grid_thw,
                second_per_grid_t=second_per_grid_t,
            ),
            Seg(VIS_CLOSE, ids[ve : ve + 1], round=rnd),
        ]
        if ve + 1 < len(ids) - 1:
            segs.append(Seg(QUERY, ids[ve + 1 : -1], round=rnd))
        segs.append(Seg(USER_CLOSE, ids[-1:], round=rnd))
        return segs

    def assistant_open_segments(self, rnd: int) -> List[Seg]:
        """[sep \n (dies with user turn rnd), <|im_start|>assistant\n]."""
        ids = self._ids("\n<|im_start|>assistant\n")
        return [
            Seg(SEP_AFTER_USER, ids[:1], round=rnd),
            Seg(ASST_OPEN, ids[1:], round=rnd),
        ]


def build_round_segs(
    builder: PromptBuilder,
    stream_cfg,
    spatial_merge_size: int,
    i: int,
    start_time: float,
    grid_thw: Tuple[int, int, int],
    *,
    query: str = "",
    previous_text: str = "",
    question: str = "",
) -> List[Seg]:
    """One streaming round's prompt segments (reference inference.py:370-388):
    round 0 carries system + previous-text + the task query; later rounds are
    just the user turn. The canonical helper behind StreamingSession, the demo
    apps, and bench.py — every serving front-end must emit the exact same
    token layout or the segment-table invariants break."""
    st = stream_cfg
    spgt = 2.0 / st.fps  # reference pos_emb.py:104
    end_time = start_time + st.chunk_duration
    g = tuple(int(x) for x in grid_thw)
    n_vid_tokens = g[0] * (g[1] // spatial_merge_size) * (g[2] // spatial_merge_size)
    segs: List[Seg] = []
    if i == 0:
        segs.append(builder.system_segment())
        segs.extend(builder.previous_text_segments(previous_text))
        segs.extend(
            builder.user_turn_segments(
                0, start_time, end_time, n_vid_tokens, g, spgt,
                query=query, question=question,
            )
        )
    else:
        segs.extend(
            builder.user_turn_segments(
                i, start_time, end_time, n_vid_tokens, g, spgt,
                question=question,
            )
        )
    segs.extend(builder.assistant_open_segments(i))
    return segs


# ---------------------------------------------------------------------------
# Tokenizer adapters
# ---------------------------------------------------------------------------


def hf_encode_fn(tokenizer) -> EncodeFn:
    """Adapt a HF tokenizer (with Qwen special tokens) to EncodeFn."""

    def encode(text: str) -> List[int]:
        return tokenizer(text, add_special_tokens=False)["input_ids"]

    return encode


class FakeTokenizer:
    """Deterministic char-level tokenizer for CPU tests: special-token literals
    map to the tiny config's special ids, every other character hashes into
    [30, 1000)."""

    SPECIALS = {
        "<|im_start|>": "im_start",
        "<|im_end|>": "im_end",
        "<|vision_start|>": "vision_start",
        "<|vision_end|>": "vision_end",
        "<|video_pad|>": "video_pad",
        "<|image_pad|>": "image_pad",
    }
    WORDS = {"user": "user", "assistant": "assistant", "Time": "time_word"}

    def __init__(self, tokens: SpecialTokens):
        self.tok = tokens

    def __call__(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            for lit, attr in self.SPECIALS.items():
                if text.startswith(lit, i):
                    out.append(getattr(self.tok, attr))
                    i += len(lit)
                    matched = True
                    break
            if matched:
                continue
            if text.startswith("previous text", i):
                out.extend(self.tok.previous_text)
                i += len("previous text")
                continue
            for word, attr in self.WORDS.items():
                if text.startswith(word, i):
                    out.append(getattr(self.tok, attr))
                    i += len(word)
                    matched = True
                    break
            if matched:
                continue
            ch = text[i]
            if ch == "\n":
                out.append(self.tok.newline)
            else:
                out.append(30 + (ord(ch) * 7) % 900)
            i += 1
        return out
