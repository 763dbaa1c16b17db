"""The port's codecs.  Importing the package registers the VVC encoder
(``vvc``), as the JAX package's registry holds it from the start; the
other encoders register when their packages are imported."""

from . import vvc  # noqa: F401  (registers VvcEncoder)
