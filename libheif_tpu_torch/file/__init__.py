from .heif_file import HeifFile

__all__ = ["HeifFile"]
