"""Scene files without h5py (``h5``, ``schema``, ``index``, ``dataset``),
padding, and synthetic scenes and clouds."""

from himo_tpu_torch.data.schema import FrameData, write_frame, read_frame, SCHEMA_DTYPES  # noqa: F401
from himo_tpu_torch.data.dataset import SceneFlowDataset, HDF5Dataset  # noqa: F401
from himo_tpu_torch.data.index import create_reading_index, load_index, save_index  # noqa: F401
from himo_tpu_torch.data.padding import pad_to_bucket, bucket_size  # noqa: F401
