"""Filesystems the checkpoints are written through, and the native helper
library (string hashing, CRC32, the Criteo parser and loader)."""
from . import filesystem, native
from .filesystem import (FileSystem, LocalFileSystem, MemFileSystem,
                         get_filesystem, parse_oss_uri, register_filesystem)
