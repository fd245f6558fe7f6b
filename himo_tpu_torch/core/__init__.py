"""Compensation math and the de-skew pipeline (port of :mod:`himo_tpu.core`)."""
