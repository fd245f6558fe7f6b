"""Scene-flow EPE/Acc metrics CLI (port of ``himo_tpu/cli/eval_flow.py``).

    python -m himo_tpu_torch.cli.eval_flow data_dir=/path/to/av2 res_names='["nsfp","fastnsf"]'

Writes ``res-flow-{data}.json`` in the working directory, next to the HiMo
``res-{data}.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

from himo_tpu_torch.core.dataset_id import infer_dataset_name
from himo_tpu_torch.eval.flow_metrics import evaluate_flow_metrics
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    res_names=("raw",),
    output_json: str = "",
    scene_filter: str = "",
):
    """``scene_filter`` (scene-id substring, e.g. ``scene_adv``) restricts
    scoring to matching scenes and suffixes the output json ``-{filter}``."""
    if isinstance(res_names, str):
        res_names = [res_names]
    results = {}
    for name in res_names:
        results[name] = evaluate_flow_metrics(
            data_dir, name, scene_filter=scene_filter
        )
    data_name = infer_dataset_name(str(data_dir))
    suffix = f"-{scene_filter.strip('_')}" if scene_filter else ""
    path = Path(output_json or f"res-flow-{data_name}{suffix}.json")
    existing = {}
    if path.exists():
        existing = json.loads(path.read_text())
    existing.update(results)
    path.write_text(json.dumps(existing, indent=2))
    print(f"Results saved to {path}")
    return results


if __name__ == "__main__":
    run_cli(main)
