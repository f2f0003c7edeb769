"""Image layer: the image-struct column and its readers."""

from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.image.imageIO import readImages, readImagesWithCustomFn

__all__ = ["imageIO", "readImages", "readImagesWithCustomFn"]
