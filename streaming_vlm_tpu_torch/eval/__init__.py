"""Evaluation harnesses of the port (ports of the JAX package's eval/):
`soak` and `efficiency` (the paper's four attention policies), `mcq` and
`ovobench` (MCQ scoring), `vqa` and `vlmeval_compat` (VLMEvalKit-style
chat), `infstream`, `livesports` and `gpt_competitor` (streaming
commentary against judges), `judge` (A/B double votes)."""

from . import efficiency, gpt_competitor, infstream, judge, livesports, mcq, ovobench, soak, vqa  # noqa: F401
