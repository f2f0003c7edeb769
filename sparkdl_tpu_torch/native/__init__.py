"""Native (C++) host-side components of the port: the JPEG/PNG image
loader (``image_loader.cc``), built with g++ at first use and bound with
ctypes in :mod:`~sparkdl_tpu_torch.native.loader`, with Pillow taking
its place where it cannot be built."""

from sparkdl_tpu_torch.native import loader

__all__ = ["loader"]
