"""I/O helpers (``io.py``, a copy of ``plotweave/utils/io.py``) and the
device policy of the raster chain (``devices.py``)."""

from .io import (load_pickle, save_pickle, load_json, save_json, read_image,
                 write_image, register_device_artifact, fetch_device_artifact, thread_map,
                 register_derived_artifact, fetch_derived_artifact)

__all__ = ["load_pickle", "save_pickle", "load_json", "save_json", "read_image",
           "write_image", "register_device_artifact", "fetch_device_artifact", "thread_map",
           "register_derived_artifact", "fetch_derived_artifact"]
