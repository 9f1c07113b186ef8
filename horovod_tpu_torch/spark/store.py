"""Artifact stores for Spark-style estimator training.

The port of the JAX package's ``horovod_tpu/spark/store.py``, with the
same on-disk layout. Parity: ``horovod/spark/common/store.py`` --
``Store`` (``:32``), ``FilesystemStore`` (``:153``), ``LocalStore``,
``HDFSStore``. A store owns the layout of training artifacts (prepared data, per-run
checkpoints, logs) under a prefix path, so estimators can checkpoint on
rank 0 and reload best weights (SURVEY.md §5.4).

Checkpoints are ``torch.save`` blobs of parameter dicts (the estimators'
``serialize``) rather than Keras HDF5, but the layout contract
(``<prefix>/runs/<run_id>/checkpoint`` + ``.../logs``) is kept so tooling parity holds. HDFS/cloud
filesystems are gated on ``fsspec`` availability; the local filesystem
path has no extra dependencies.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional


class Store:
    """Abstract artifact store (reference ``store.py:32-151``)."""

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path

    # -- data layout -------------------------------------------------
    def get_train_data_path(self, idx=None) -> str:
        sub = "train_data" if idx is None else f"train_data.{idx}"
        return os.path.join(self.prefix_path, "intermediate", sub)

    def get_val_data_path(self, idx=None) -> str:
        sub = "val_data" if idx is None else f"val_data.{idx}"
        return os.path.join(self.prefix_path, "intermediate", sub)

    def get_test_data_path(self, idx=None) -> str:
        sub = "test_data" if idx is None else f"test_data.{idx}"
        return os.path.join(self.prefix_path, "intermediate", sub)

    # -- run layout --------------------------------------------------
    def get_runs_path(self) -> str:
        return os.path.join(self.prefix_path, "runs")

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self.get_runs_path(), run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id),
                            self.get_checkpoint_filename())

    def get_epoch_checkpoint_path(self, run_id: str, epoch: int) -> str:
        """Per-epoch checkpoint (reference trainers write one per epoch
        and reload the best, ``spark/keras/remote.py``)."""
        return os.path.join(
            self.get_run_path(run_id),
            f"checkpoint.epoch_{epoch:04d}" + os.path.splitext(
                self.get_checkpoint_filename())[1],
        )

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id),
                            self.get_logs_subdir())

    def get_checkpoint_filename(self) -> str:
        return "checkpoint.msgpack"

    def get_logs_subdir(self) -> str:
        return "logs"

    # -- IO (subclass responsibility) --------------------------------
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def open(self, path: str):
        """Binary file-like for streaming reads. Base fallback buffers the
        whole object (read()); FS/fsspec stores return true streaming
        handles so big shards are never fully resident
        (``util.iter_shard_batches`` — the Petastorm-reader analog)."""
        import io

        return io.BytesIO(self.read(path))

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Pick a store from the path scheme (reference ``store.py:144``)."""
        if prefix_path.startswith(("hdfs://", "gs://", "s3://", "s3a://")):
            return FsspecStore(prefix_path, *args, **kwargs)
        return FilesystemStore(prefix_path, *args, **kwargs)


class FilesystemStore(Store):
    """Local/NFS filesystem store (reference ``store.py:153-252``)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        self.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(data)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return sorted(
            os.path.join(path, p) for p in os.listdir(path)
        )

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def open(self, path: str):
        return open(path, "rb")


class LocalStore(FilesystemStore):
    """Alias of FilesystemStore (reference keeps both names)."""


class FsspecStore(Store):
    """HDFS / object-store backend via ``fsspec`` (reference
    ``HDFSStore``/``DBFSLocalStore``; gated on the optional dep)."""

    def __init__(self, prefix_path: str, *args, **kwargs):
        super().__init__(prefix_path)
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "remote store paths require the 'fsspec' package"
            ) from e
        self._fs = fsspec.open(prefix_path).fs

    def exists(self, path: str) -> bool:  # pragma: no cover - needs fsspec
        return self._fs.exists(path)

    def read(self, path: str) -> bytes:  # pragma: no cover
        with self._fs.open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:  # pragma: no cover
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def makedirs(self, path: str) -> None:  # pragma: no cover
        self._fs.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:  # pragma: no cover
        return sorted(self._fs.ls(path))

    def delete(self, path: str) -> None:  # pragma: no cover
        self._fs.rm(path, recursive=True)

    def open(self, path: str):  # pragma: no cover
        return self._fs.open(path, "rb")
