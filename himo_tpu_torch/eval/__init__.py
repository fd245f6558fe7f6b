"""Host-side evaluation: the HiMo instance metrics and the scene-flow metrics
(port of :mod:`himo_tpu.eval`'s flow-mode parts)."""
