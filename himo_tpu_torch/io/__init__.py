"""Leaderboard submission I/O (port of :mod:`himo_tpu.io`): feather (Arrow
IPC) frames zipped per scene, read and written without pandas."""

from himo_tpu_torch.io.submission import (  # noqa: F401
    read_comp_dis_zip,
    write_comp_dis_feather,
    zip_results,
    list_sweep_uuids,
)
