"""Load a real VLMEvalKit checkout and drive it with the VQAChat adapter.

A copy of the JAX package's streaming_vlm_tpu/eval/vlmeval_compat.py (it
runs no model; `run_kit_mcq` drives whatever VQAChat-compatible chat it is
given, here the port's `eval.vqa.VQAChat`). The kit is an external runtime
dependency: point `load_vlmeval(path)` at any checkout and it becomes
importable. The kit's import graph eagerly pulls optional heavy deps
(torchvision, decord, api client SDKs, ...) that plain MCQ evaluation
never calls: `load_vlmeval` installs inert stub modules for the missing
ones, so the MCQ path (dataset TSV handling, build_prompt, answer
matching) runs with only pandas / numpy / PIL / torch.

Run an MCQ dataset end to end with `run_kit_mcq(chat, dataset_name)`: the
KIT builds the dataset and per-item prompts; the model answers.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
import types
from typing import Dict, List, Optional

# optional deps the kit imports at module scope but MCQ evaluation never
# executes; anything importable for real is NOT stubbed
_STUB_WHITELIST = (
    "validators", "portalocker", "timeout_decorator", "sty", "torchvision",
    "decord", "av", "moviepy", "xlsxwriter", "openpyxl", "tabulate", "docx",
    "ipdb", "imageio", "librosa", "soundfile", "cv2", "skimage", "pydub",
    "gradio", "openai", "anthropic", "google", "dashscope", "zhipuai",
    "reka", "boto3", "groq", "mistralai",
)


class _Any:
    def __getattr__(self, k):
        return _Any()

    def __call__(self, *a, **kw):
        return _Any()

    def __str__(self):
        return ""

    def __bool__(self):
        # stubs must read as "absent/false": e.g. a stubbed validators.url()
        # must NOT make the kit treat a local path as a downloadable URL
        return False


class _AnyModule(types.ModuleType):
    __path__: List[str] = []

    def __getattr__(self, k):
        if k.startswith("__"):
            raise AttributeError(k)
        return _Any()


# top-level names the finder actually fabricated (i.e. the real package was
# missing): inspect or log this to diagnose a kit code path silently running
# against a stub instead of a real dependency
stubbed_modules: set = set()


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _STUB_WHITELIST:
            stubbed_modules.add(name.split(".")[0])
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        return _AnyModule(spec.name)

    def exec_module(self, module):
        pass


_loaded_from: Optional[str] = None


def load_vlmeval(kit_path: str):
    """Make `vlmeval` importable from a checkout at `kit_path`. Returns the
    imported top-level module. Idempotent."""
    global _loaded_from
    if _loaded_from is not None:
        return sys.modules["vlmeval"]
    for name in _STUB_WHITELIST:
        try:
            __import__(name)
        except Exception:
            pass  # leave missing; the finder below fabricates it on demand
    if "validators" not in sys.modules:
        # needs real semantics: the kit branches on validators.url(path)
        v = types.ModuleType("validators")
        v.url = lambda s: isinstance(s, str) and s.startswith(("http://", "https://"))
        sys.modules["validators"] = v
    if not any(isinstance(f, _StubFinder) for f in sys.meta_path):
        sys.meta_path.append(_StubFinder())
    if kit_path not in sys.path:
        sys.path.insert(0, kit_path)
    import vlmeval  # noqa: F401

    _loaded_from = kit_path
    if stubbed_modules:
        import logging

        logging.getLogger(__name__).info(
            "vlmeval loaded with stubbed optional deps: %s",
            ", ".join(sorted(stubbed_modules)),
        )
    return vlmeval


def run_kit_mcq(
    chat,
    dataset_name: str,
    *,
    kit_path: str,
    out_path: Optional[str] = None,
) -> Dict[str, float]:
    """Evaluate `chat` (VQAChat-compatible: .generate(message, dataset)) on a
    VLMEvalKit MCQ dataset BY THE KIT'S OWN machinery: ImageMCQDataset loads
    the TSV (set $LMUData for custom local datasets), dumps images, and
    builds each prompt; answers are matched with our exact-match extractor
    (the kit's first-stage matcher; its LLM-judge fallback needs an API key).
    """
    import json
    import string

    load_vlmeval(kit_path)
    from vlmeval.dataset.image_mcq import ImageMCQDataset

    from .vqa import extract_option

    ds = ImageMCQDataset(dataset=dataset_name)
    n_correct = n_total = 0
    records = []
    for i in range(len(ds.data)):
        line = ds.data.iloc[i]
        msgs = ds.build_prompt(line)
        pred = chat.generate(msgs, dataset=dataset_name)
        opts = [
            c
            for c in string.ascii_uppercase
            if c in line and str(line[c]) not in ("", "nan", "None")
        ]
        choice = extract_option(pred, opts)
        hit = choice is not None and choice == str(line.get("answer"))
        n_total += 1
        n_correct += int(hit)
        records.append(
            {
                "index": str(line["index"]),
                "prediction": pred,
                "choice": choice,
                "answer": str(line.get("answer")),
                "hit": int(hit),
            }
        )
    if out_path:
        with open(out_path, "w") as f:
            for r in records:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return {
        "total": n_total,
        "correct": n_correct,
        "accuracy": n_correct / n_total if n_total else 0.0,
    }
