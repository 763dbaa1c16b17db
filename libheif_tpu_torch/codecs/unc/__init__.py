from .codec import UnciDecoder, UnciEncoder

# the unci/mask registry shims are registered by codecs/__init__.py, in
# the JAX package's place in the list (hevc's kernels import this package
# before the hevc codec registers)

__all__ = ["UnciDecoder", "UnciEncoder"]
