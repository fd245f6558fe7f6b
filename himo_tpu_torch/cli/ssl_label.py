"""Generate SSL pseudo-labels (dynamic masks, clusters, translation priors)
for a dataset (port of ``himo_tpu/cli/ssl_label.py``):

    python -m himo_tpu_torch.cli.ssl_label dataset_path=/path/to/av2
    python -m himo_tpu_torch.cli.ssl_label dataset_path=... method=dufo   # DUFOMap-style

Labelling runs on the host (numpy and scipy); each scene file is rewritten
whole with its ``ssl_*`` datasets (``training/ssl_labels.py``).
"""

from __future__ import annotations

from himo_tpu_torch.training.ssl_labels import write_ssl_labels, write_ssl_labels_dufo
from himo_tpu_torch.utils.cli import run_cli


def main(
    dataset_path: str = "",
    threshold: float = 0.18,
    method: str = "nn",  # 'nn' (frame-pair residual) | 'dufo' (occupancy)
    voxel: float = 0.4,
):
    if method == "dufo":
        n = write_ssl_labels_dufo(dataset_path, voxel=voxel, threshold=threshold)
    else:
        n = write_ssl_labels(dataset_path, threshold=threshold)
    print(f"Labeled {n} frames in {dataset_path} ({method})")
    return n


if __name__ == "__main__":
    run_cli(main)
