"""The port's codecs.  Importing the package registers every built-in
decoder and encoder, in the order of libheif_tpu/codecs/__init__.py:4-10
(hevc, av1, jpeg, avc, unc, j2k, vvc), so that the registry lists them
as the JAX package's does."""

from . import registry  # noqa: F401

from . import hevc  # noqa: F401  (registers the HEVC codec)
from . import av1   # noqa: F401  (registers the AV1 codec)
from . import jpeg  # noqa: F401  (registers the JPEG codec)
from . import avc   # noqa: F401  (registers the AVC codec)
from . import unc   # noqa: F401  (registers the built-in unci/mask shims)
from . import j2k   # noqa: F401  (registers the JPEG 2000 codec)
from . import vvc   # noqa: F401  (registers the VVC codec)
