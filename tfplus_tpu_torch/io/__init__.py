"""Filesystems the checkpoints are written through (local, ``ram://``, and
the remote clients ``oss://``, ``s3://`` and ``dfs://`` with their
in-process emulators), and the native helper library (string hashing,
CRC32, the Criteo parser and loader)."""
from . import filesystem, native
from .filesystem import (FileSystem, LocalFileSystem, MemFileSystem,
                         get_filesystem, parse_oss_uri, register_filesystem)
from .object_store import (ObjectStoreClient, OSSFileSystem, register_oss)
from .dfs import (DfsClient, DfsFileSystem, register_dfs)
from .s3 import (S3Client, S3FileSystem, parse_s3_uri, register_s3)
