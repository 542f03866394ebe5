"""Native C++ dataset I/O (the port's copy of the reference's
`image_io.cc`), bound with ctypes: a PNG/PGM decoder and a threaded
prefetcher. Host I/O, not a kernel: where the library cannot be built, the
dataset loaders decode with PIL, and `build_error()` says why."""

from orbslam2_tpu_torch.native.imageio import (  # noqa: F401
    Prefetcher,
    build_error,
    decode_image,
    native_available,
)
