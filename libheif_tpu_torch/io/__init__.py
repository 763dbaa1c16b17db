"""Input readers: the streaming reader protocol (``reader.py``).  The
image-file codecs of the JAX package's ``io/`` serve its command-line
tools and are not ported."""

from .reader import (
    CallbackReader, FileReader, GrowStatus, MemoryReader, StreamReader)

__all__ = ["CallbackReader", "FileReader", "GrowStatus", "MemoryReader",
           "StreamReader"]
