"""Detection-on-compensated-clouds harness CLI (port of
``himo_tpu/cli/det_h5.py``).

Runs detection over raw and de-skewed clouds and compares quality, the
surface of the reference's OpenPCDet ``tools/h5sf.py`` experiment.
``detector=learned`` trains and runs the center-point DetNet (the
TransFusion-class learned role) on the GPU (``device=cpu`` runs it on the
CPU); the default geometric detector needs no training and runs on the
host.

With ``detector=learned`` and no ``train_dir``, the DetNet trains on the
same frames it is evaluated on: absolute P/R/F1 are optimistic from the
train/eval overlap (the raw-vs-compensated delta stays consistent, since
both modes share one set of weights). Pass a held-out ``train_dir`` for
honest absolute numbers.

    python -m himo_tpu_torch.cli.det_h5 data_dir=... flow_modes='["raw","seflowpp"]'
    python -m himo_tpu_torch.cli.det_h5 data_dir=... detector=learned epochs=8
"""

from __future__ import annotations

from himo_tpu_torch.downstream.detection import DetectionConfig, evaluate_detection
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    flow_modes=("raw", "flow"),
    iou_threshold: float = 0.3,
    dynamic_only: bool = True,
    detector: str = "geometric",  # or 'learned' (center-point DetNet)
    train_dir: str = "",  # learned: training dataset (defaults to data_dir)
    epochs: int = 8,
    num_points: int = 32768,
    voxel: float = 0.4,
    device=None,
):
    if isinstance(flow_modes, str):
        flow_modes = [flow_modes]
    results = {}
    if detector == "learned":
        from himo_tpu_torch.downstream.det_net import (
            evaluate_detection_learned,
            make_det_model,
            train_detector,
        )
        from himo_tpu_torch.ops.voxelize import PillarConfig

        model, _ = make_det_model(
            device=device, pillar=PillarConfig(voxel_size=(voxel, voxel))
        )
        params = train_detector(
            train_dir or data_dir, model=model, num_points=num_points,
            epochs=epochs,
        )
        for mode in flow_modes:
            results[mode] = evaluate_detection_learned(
                data_dir, model, params, flow_mode=mode,
                num_points=num_points, iou_threshold=iou_threshold,
                dynamic_only=dynamic_only,
            )
    else:
        config = DetectionConfig(iou_threshold=iou_threshold)
        for mode in flow_modes:
            results[mode] = evaluate_detection(
                data_dir, flow_mode=mode, config=config, dynamic_only=dynamic_only
            )
    print("\nmode        P      R      F1     meanIoU")
    for mode, r in results.items():
        print(
            f"{mode:<10} {r['precision']:.3f}  {r['recall']:.3f}  "
            f"{r['f1']:.3f}  {r['mean_iou']:.3f}"
        )
    return results


if __name__ == "__main__":
    run_cli(main)
