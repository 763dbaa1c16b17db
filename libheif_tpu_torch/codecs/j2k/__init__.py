"""JPEG 2000 (`j2k1`): decode and encode on the host, as in the JAX
package (libheif_tpu/codecs/j2k/): the marker and packet parse, the
tier-1 block coders (EBCOT MQ and HT, C++ in host/, built as the
``j2k_host`` library) and the numpy wavelets; the planes move between
the host and the device in one copy each way (codec.py).  Importing the
package registers the ``jpeg2000`` decoder and the ``jpeg2000`` and
``htj2k`` encoders, as libheif_tpu/codecs/j2k/__init__.py:15 does."""

from .codec import (HTJ2KEncoder_Registry, J2KEncoder_Registry,
                    J2KImageDecoder, register)
from .decoder import J2KDecoder, decode_codestream
from .encoder import J2KEncoder, encode_codestream

register()

__all__ = ["HTJ2KEncoder_Registry", "J2KDecoder", "J2KEncoder",
           "J2KEncoder_Registry", "J2KImageDecoder", "decode_codestream",
           "encode_codestream"]
