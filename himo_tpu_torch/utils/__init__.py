"""Config overrides, the CLI, metrics logging and weight conversion."""

from himo_tpu_torch.utils.cli import run_cli  # noqa: F401
from himo_tpu_torch.utils.profiling import Timer, stage_timer  # noqa: F401
