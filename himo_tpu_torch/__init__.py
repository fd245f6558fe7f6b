"""himo_tpu_torch — the PyTorch/CUDA port of :mod:`himo_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module paths
and public names (``himo_tpu_torch/ops/voxelize.py::scatter_max`` mirrors
``himo_tpu/ops/voxelize.py::scatter_max``) and imports nothing from it, nor
from ``jax`` or ``flax``: the GPU host has neither.

Layout
------
- :mod:`himo_tpu_torch.core`    — compensation math and the de-skew pipeline.
- :mod:`himo_tpu_torch.ops`     — pillar scatter/gather, streaming NN,
  connected components, per-slot refinement.
- :mod:`himo_tpu_torch.kernels` — builds ``csrc/*.cu`` with ``nvcc`` on first
  use and loads them with ``ctypes``.
- :mod:`himo_tpu_torch.models`  — the feed-forward flow networks and the
  estimator registry.
- :mod:`himo_tpu_torch.training` — SSL losses, the train loop, checkpoints.
- :mod:`himo_tpu_torch.cli`     — ``python -m himo_tpu_torch.cli.train``.
- :mod:`himo_tpu_torch.utils`   — config overrides, the CLI parser, metrics
  logging, flax -> torch weights.
- :mod:`himo_tpu_torch.data`    — the scene files in numpy (no h5py), the
  dataset, synthetic scenes and LiDAR-like clouds.

Numerics: every float32 matmul and convolution runs in full float32. TF32
would keep about three decimal digits, which is enough to flip the port's
discrete decisions (gate, occupancy, slot acceptance), so importing the
package turns it off for both cuBLAS and cuDNN.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from himo_tpu_torch.core.compensation import (  # noqa: E402,F401
    dt0_from_lidar_dt,
    ego_points_mask,
    flow_to_comp_dis,
    pose_flow,
    refine_points,
)
