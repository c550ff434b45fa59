"""NIfTI volumes: ``nifti`` (the pure-Python reader and writer)."""
