"""Build an ``index_eval.pkl`` subset from ``index_total.pkl`` (port of
``himo_tpu/cli/pkl_extract.py``).

Surface of the reference's ``tools/pkl_extract.py`` (:5-19) demo-subset
builder, generalized with scene filtering / striding / cap:

    python -m himo_tpu_torch.cli.pkl_extract data_dir=... max_frames=70
    python -m himo_tpu_torch.cli.pkl_extract data_dir=... scene_ids='["scene_000"]'
"""

from __future__ import annotations

from himo_tpu_torch.data.index import extract_eval_index
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    scene_ids=None,
    every_n: int = 1,
    max_frames=None,
):
    if isinstance(scene_ids, str):
        scene_ids = [scene_ids]
    subset = extract_eval_index(
        data_dir, scene_ids=scene_ids, every_n=every_n, max_frames=max_frames
    )
    print(f"Wrote index_eval.pkl with {len(subset)} frames.")
    return subset


if __name__ == "__main__":
    run_cli(main)
