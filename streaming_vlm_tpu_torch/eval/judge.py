"""LLM A/B judge with position-swapped double voting.

A copy of the JAX package's streaming_vlm_tpu/eval/judge.py (it runs no
model): a GPT judge answers 'A' or 'B', an AB vote and a BA vote flipped
back, each call retried with backoff. The judge is a callable (system,
user) -> text, so tests inject a deterministic fake and offline runs fail
loudly instead of hanging; `openai` is imported only by `openai_judge_fn`."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Tuple

SYS_PROMPT = """You are a strict A/B evaluator for sports video commentary.

Rules:
1) You MUST output exactly one uppercase letter: "A" or "B".

2) Evaluate in this order:

Broadcast tone & pacing: Vary the emotion; deliver live play-by-play or brief, in-the-moment analysis. Not just scene description. Use a real-time broadcast voice that puts the audience courtside.

Consistency & accuracy: Every detail must stay synchronized with the visuals and never contradict them."""

USER_TEMPLATE = (
    "Reference transcript (Provide a reference for the tone and on-screen information):\n"
    "{reference}\n\n"
    "Candidate A:\n{A}\n\n"
    "Candidate B:\n{B}\n\n"
)

JudgeFn = Callable[[str, str], str]  # (system, user) -> raw text


def openai_judge_fn(model: str = "gpt-4o-mini", max_retries: int = 8) -> JudgeFn:
    """Judge via an OpenAI-compatible endpoint (OPENAI_KEY / OPENAI_BASE_URL)."""
    from openai import OpenAI  # optional dep; only imported when used

    api_key = os.environ.get("OPENAI_KEY") or os.environ.get("OPENAI_API_KEY")
    base = os.environ.get("OPENAI_BASE_URL") or os.environ.get("OPENAI_API_BASE")
    client = OpenAI(api_key=api_key, base_url=base) if base else OpenAI(api_key=api_key)

    def call(system: str, user: str) -> str:
        last = None
        for attempt in range(max_retries):
            try:
                resp = client.chat.completions.create(
                    model=model,
                    messages=[
                        {"role": "system", "content": system},
                        {"role": "user", "content": user},
                    ],
                    temperature=0.0,
                )
                return resp.choices[0].message.content or ""
            except Exception as e:  # transient API errors: retry with backoff
                last = e
                if attempt < max_retries - 1:  # no pointless final sleep
                    time.sleep(min(2**attempt, 30))
        raise RuntimeError(f"judge failed after {max_retries} retries: {last}")

    return call


def judge_once(judge: JudgeFn, ref_text: str, cand_a: str, cand_b: str) -> str:
    """One vote: 'A', 'B', or 'tie'. An off-format reply ('Candidate A is
    better', an empty refusal, ...) falls back to the reference's
    containment parse (llm_judge.py:56-61) and otherwise counts for NEITHER
    side — defaulting it to a vote (as a startswith-else-B parse does)
    silently biases the win rate."""
    msg = USER_TEMPLATE.format(
        reference=ref_text.strip()[:8000],
        A=cand_a.strip()[:8000],
        B=cand_b.strip()[:8000],
    )
    out = judge(SYS_PROMPT, msg).strip().upper()
    if out.startswith("A"):
        return "A"
    if out.startswith("B"):
        return "B"
    has_a = "CANDIDATE A" in out
    has_b = "CANDIDATE B" in out
    if has_a != has_b:
        return "A" if has_a else "B"
    return "tie"


_FLIP = {"A": "B", "B": "A", "tie": "tie"}


def judge_pair(judge: JudgeFn, ref_text: str, cand_a: str, cand_b: str) -> Tuple[str, str]:
    """AB vote + position-swapped BA vote (flipped back to A/B perspective)."""
    vote_ab = judge_once(judge, ref_text, cand_a, cand_b)
    vote_ba = _FLIP[judge_once(judge, ref_text, cand_b, cand_a)]
    return vote_ab, vote_ba


def tally(vote_ab: str, vote_ba: str) -> Dict[str, object]:
    votes_a = int(vote_ab == "A") + int(vote_ba == "A")
    votes_b = int(vote_ab == "B") + int(vote_ba == "B")
    winner = "A" if votes_a > votes_b else "B" if votes_b > votes_a else "equal"
    return {"winner": winner, "votes": {"A": votes_a, "B": votes_b}}
