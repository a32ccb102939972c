"""Filesystems the checkpoints are written through."""
from . import filesystem
from .filesystem import (FileSystem, LocalFileSystem, MemFileSystem,
                         get_filesystem, parse_oss_uri, register_filesystem)
