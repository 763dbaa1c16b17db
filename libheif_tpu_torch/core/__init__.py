from .error import HeifError, ErrorCode, SubError
from .fourcc import fourcc, fourcc_to_str
from .bitstream import ByteReader, ByteWriter
from .limits import SecurityLimits

__all__ = [
    "HeifError", "ErrorCode", "SubError",
    "fourcc", "fourcc_to_str",
    "ByteReader", "ByteWriter",
    "SecurityLimits",
]
