"""Scene files without h5py (``h5``, ``schema``, ``index``, ``dataset``),
padding, and synthetic scenes and clouds."""
