"""The data path: NIfTI volumes (``nifti``, the Python reader and writer;
``nifti_fast`` and ``native_ops``, the native reader and rotation built
from ``native/``), the host-side transforms, the dataset split and threaded
patch loader (``dataset``) and the host→device prefetch (``prefetch``)."""
