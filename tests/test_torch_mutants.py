"""chip_smoke.py's deliberate faults (MUTANTS) against the port's current
sources, on the CPU: each text a fault replaces stands exactly once in its
file, as phase_mutants requires before it builds the copy on the card, and
each fault names the kernels whose checks alone must reject it. A text that
no longer matches after an edit shows here, not after a chip call."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("name", sorted(chip_smoke.MUTANTS))
def test_mutant_applies_once(name):
    kernel, src, text, repl, where = chip_smoke.MUTANTS[name]
    code = (REPO / "streaming_vlm_tpu_torch" / src).read_text()
    texts, repls = (text, repl) if isinstance(text, tuple) else ((text,), (repl,))
    assert len(texts) == len(repls) > 0
    for a, b in zip(texts, repls):
        assert code.count(a) == 1, f"{a!r} is not once in {src}"
        assert a != b
    assert isinstance(kernel, str) or (isinstance(kernel, tuple) and kernel)
    assert where is None or isinstance(where, str) or all(isinstance(w, str) for w in where)
