"""imageencoder_tpu — JAX block-transform image & video codec (GPU device
path, C++ host runtime).

Public API:
    encode_image / decode_image   still images (reference wire format)
    encode_video / decode_video   GOP/motion-compensated video
    QuantMatrix                   quantization matrices
    drivers: ImageEncoder, ImageDecoder, VideoEncoder, VideoDecoder
"""

from .models.image import (ImageDecoder, ImageEncoder, decode_image,  # noqa: F401
                           encode_image)
from .models.video import (VideoDecoder, VideoEncoder, decode_video,  # noqa: F401
                           encode_video)
from .utils.quant import QuantMatrix  # noqa: F401

__version__ = "0.1.0"
