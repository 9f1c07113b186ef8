"""DataFrame → sharded-parquet materialization for estimator training.

The port of the JAX package's ``horovod_tpu/spark/util.py``: the same
shard files, file for file and row for row. pandas and pyarrow are
imported inside the functions that need them.

Parity: ``horovod/spark/common/util.py`` (``prepare_data`` — write the
DataFrame as partitioned parquet into the store's intermediate paths;
``horovod/spark/common/store.py:85-97`` layout) with the Petastorm
reader replaced by pyarrow shard files read back through the Store
abstraction, so every store backend (local FS, fsspec remotes) serves
shards the same way.

Two ingestion paths:
* a pyspark DataFrame (when pyspark is installed) is repartitioned and
  written by the executors — the reference's distributed path;
* a pandas DataFrame is sharded locally through pyarrow — the
  no-cluster path that keeps the identical on-store layout, which is
  also how the pipeline is tested without a Spark installation.
"""

from __future__ import annotations

import contextlib
import io
import itertools
from typing import List, Optional, Tuple

import numpy as np

from .store import Store

_DONE_MARKER = "_SUCCESS"  # hadoop-convention completion marker

# read_shard holds every shard file of a rank open at once (single-pass
# row count + iteration); above this many files, fall back to two
# sequential passes so fd limits (ulimit, fsspec sockets) are respected.
_MAX_OPEN_SHARDS = 256


def _is_spark_df(df) -> bool:
    mod = type(df).__module__
    return mod.startswith("pyspark.")


def prepare_data(
    store: Store,
    df,
    *,
    feature_cols: List[str],
    label_cols: List[str],
    num_shards: int,
    validation=None,
    seed: int = 0,
    train_path: Optional[str] = None,
    val_path: Optional[str] = None,
) -> Tuple[int, int]:
    """Materialize ``df`` into parquet shards under the store's
    intermediate paths. Returns ``(train_rows, val_rows)``.

    ``validation``: either a fraction of rows (0..1) split off randomly
    into the val path, or the NAME of a column whose truthy (nonzero /
    True) rows form the validation set — the reference's
    ``util._train_val_split`` contract
    (``horovod/spark/common/util.py``; integer and boolean val columns
    are both accepted, ``test_spark.py:1209,1224``). The val column is
    dropped from the materialized data.
    ``train_path``/``val_path`` default to the store's shared
    intermediate layout; estimators pass run-scoped paths so each run's
    data is materialized fresh. Idempotent per path: an existing
    ``_SUCCESS`` marker skips the write (how concurrent ranks avoid
    duplicate materialization within one run).
    """
    if train_path is None:
        train_path = store.get_train_data_path()
    if val_path is None:
        val_path = store.get_val_data_path()
    if store.exists(f"{train_path}/{_DONE_MARKER}"):
        return _count_rows(store, train_path), _count_rows(store, val_path)

    cols = list(feature_cols) + list(label_cols)
    missing = [c for c in cols if c not in df.columns]
    if missing:
        raise ValueError(
            f"feature/label column(s) {missing} not in the DataFrame "
            f"(available: {list(df.columns)})"
        )
    if _is_spark_df(df):  # pragma: no cover - needs pyspark
        if isinstance(validation, str):
            from pyspark.sql import functions as F

            # NULL val-column rows train (coalesce to false) — matching
            # the pandas branch below, and never silently dropping rows.
            src = df.select(*(cols + [validation]))
            flag = F.coalesce(
                src[validation].cast("boolean"), F.lit(False)
            )
            train_df = src.filter(~flag).select(*cols)
            val_df = src.filter(flag).select(*cols)
        else:
            train_df, val_df = df.select(*cols), None
            if validation:
                train_df, val_df = train_df.randomSplit(
                    [1.0 - validation, validation], seed=seed
                )
        train_df.repartition(num_shards).write.mode("overwrite").parquet(
            train_path
        )
        if val_df is not None:
            val_df.repartition(num_shards).write.mode("overwrite").parquet(
                val_path
            )
        store.write(f"{train_path}/{_DONE_MARKER}", b"")
        return _count_rows(store, train_path), _count_rows(store, val_path)

    # pandas path
    if isinstance(validation, str):
        if validation not in df.columns:
            raise ValueError(
                f"validation column {validation!r} not in the DataFrame"
            )
        # NaN rows train (fillna before the cast: astype(bool) alone
        # would send NaN to True), matching the Spark branch's coalesce.
        mask = df[validation].fillna(False).astype(bool).to_numpy()
        pdf = df[cols]
        train_pdf, val_pdf = pdf[~mask], pdf[mask]
    else:
        pdf = df[cols]
        n = len(pdf)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        n_val = int(n * validation) if validation else 0
        val_idx, train_idx = order[:n_val], order[n_val:]
        train_pdf, val_pdf = pdf.iloc[train_idx], pdf.iloc[val_idx]
    _write_shards(store, train_path, train_pdf, num_shards)
    if len(val_pdf):
        _write_shards(store, val_path, val_pdf, num_shards)
    store.write(f"{train_path}/{_DONE_MARKER}", b"")
    return len(train_pdf), len(val_pdf)


def _write_shards(store: Store, path: str, pdf, num_shards: int) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(pdf)
    per = -(-n // max(1, num_shards))
    for i in range(num_shards):
        part = pdf.iloc[i * per : (i + 1) * per]
        table = pa.Table.from_pandas(part, preserve_index=False)
        sink = pa.BufferOutputStream()
        pq.write_table(table, sink)
        store.write(
            f"{path}/part-{i:05d}.parquet", sink.getvalue().to_pybytes()
        )


def _shard_files(store: Store, path: str) -> List[str]:
    if not store.exists(path):
        return []
    return [p for p in store.listdir(path) if p.endswith(".parquet")]


def _count_rows(store: Store, path: str) -> int:
    import pyarrow.parquet as pq

    total = 0
    for f in _shard_files(store, path):
        total += pq.ParquetFile(io.BytesIO(store.read(f))).metadata.num_rows
    return total


def feature_matrix(pdf, cols, *, squeeze_cols: bool = True) -> np.ndarray:
    """Extract columns into an array, always preserving the batch
    dimension (``np.squeeze`` alone turns a 1-row frame into an
    unbatched vector). ``squeeze_cols`` collapses a single column to
    1-D — the training-label convention."""
    if len(pdf) == 0:
        # .tolist() on an empty frame loses the feature dimension.
        return np.empty((0, len(cols)) if not squeeze_cols or len(cols) > 1
                        else (0,))
    arr = np.asarray(pdf[list(cols)].values.tolist())
    if squeeze_cols and arr.ndim > 1 and arr.shape[1] == 1:
        arr = arr[:, 0]
    return arr


def _has_streaming_open(store: Store) -> bool:
    """True when the store overrides :meth:`Store.open` with a real
    streaming handle; the base fallback buffers the whole object, so
    metadata-only probes against it would download full files."""
    return type(store).open is not Store.open


def shard_row_count(
    store: Store, path: str, *, rank: int, num_ranks: int
) -> int:
    """Row count of this rank's shard files from parquet METADATA only —
    no data pages are read (how the streaming path sizes itself).

    Note: against a store without a streaming ``open()`` this costs a
    full read of each file (the base fallback buffers ``read()``)."""
    import pyarrow.parquet as pq

    total = 0
    for f in _shard_files(store, path)[rank::num_ranks]:
        with store.open(f) as fh:
            total += pq.ParquetFile(fh).metadata.num_rows
    return total


def iter_shard_batches(
    store: Store,
    path: str,
    *,
    rank: int,
    num_ranks: int,
    feature_cols: List[str],
    label_cols: List[str],
    batch_rows: int,
):
    """Stream this rank's shard as ``(features, labels)`` array batches of
    at most ``batch_rows`` rows — bounded memory by construction: one
    parquet record batch is resident at a time, via ``Store.open``
    streaming handles (``pq.ParquetFile.iter_batches``).

    The per-worker half of the reference's Petastorm reader
    (``horovod/spark/keras/remote.py`` ``make_reader`` loop): worker ``r``
    of ``n`` consumes files ``r, r+n, r+2n, …`` so the global dataset is
    partitioned without coordination, and training iterates the reader
    instead of holding the dataset in memory.
    """
    import pyarrow.parquet as pq

    for f in _shard_files(store, path)[rank::num_ranks]:
        with store.open(f) as fh:
            pf = pq.ParquetFile(fh)
            for rb in pf.iter_batches(batch_size=batch_rows):
                pdf = rb.to_pandas()
                yield (
                    feature_matrix(pdf, feature_cols),
                    feature_matrix(pdf, label_cols),
                )


def shard_label_dtype(
    store: Store, path: str, label_cols: List[str]
) -> np.dtype:
    """Numpy result dtype of the label columns from the parquet SCHEMA —
    not from a materialized record batch.  The distinction matters for
    ``loss='auto'``: a nullable int64 label column materializes as
    float64-with-NaN in any batch that carries a null, which would
    silently flip auto-selection from cross-entropy to MSE; the schema
    keeps the declared integer type."""
    import pyarrow.parquet as pq

    files = _shard_files(store, path)
    if not files:
        return np.dtype(np.float64)
    with contextlib.closing(store.open(files[0])) as fh:
        schema = pq.ParquetFile(fh).schema_arrow
    dtypes = []
    for c in label_cols:
        if c in schema.names:
            dtypes.append(np.dtype(schema.field(c).type.to_pandas_dtype()))
    return np.result_type(*dtypes) if dtypes else np.dtype(np.float64)


def read_shard(
    store: Store,
    path: str,
    *,
    rank: int,
    num_ranks: int,
    feature_cols: List[str],
    label_cols: List[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Read this rank's shard files (round-robin by file) back to arrays.

    Built on a single pass per file with preallocated outputs (row count
    from metadata): peak memory is the result arrays plus one record
    batch, not the 2-3x transient of a read-everything-then-concat.
    Every store opens each shard file ONCE — streaming stores reuse the
    open ``ParquetFile`` (whose footer metadata served the row-count
    pass) for the batch iteration instead of paying a second
    high-latency ``open()``; buffering-fallback stores reuse the fetched
    buffer for both passes."""
    import pyarrow.parquet as pq

    files = _shard_files(store, path)[rank::num_ranks]
    with contextlib.ExitStack() as stack:
        if _has_streaming_open(store) and len(files) <= _MAX_OPEN_SHARDS:
            # One open per file: the footer read that counts rows hands
            # the same ParquetFile to the iteration pass.
            pfs = [
                pq.ParquetFile(stack.enter_context(store.open(f)))
                for f in files
            ]
            n_rows = sum(pf.metadata.num_rows for pf in pfs)
        elif _has_streaming_open(store):
            # Too many shard files to hold open at once (fd limits):
            # fall back to two sequential passes — footer-only row
            # count, then one re-open per file during iteration.
            n_rows = shard_row_count(
                store, path, rank=rank, num_ranks=num_ranks
            )
            pfs = None
        else:
            pfs = [
                pq.ParquetFile(io.BytesIO(store.read(f))) for f in files
            ]
            n_rows = sum(pf.metadata.num_rows for pf in pfs)

        def _iter():
            for pf in pfs:
                for rb in pf.iter_batches(batch_size=65536):
                    pdf = rb.to_pandas()
                    yield (
                        feature_matrix(pdf, feature_cols),
                        feature_matrix(pdf, label_cols),
                    )

        it = (
            _iter()
            if pfs is not None
            else iter_shard_batches(
                store,
                path,
                rank=rank,
                num_ranks=num_ranks,
                feature_cols=feature_cols,
                label_cols=label_cols,
                batch_rows=65536,
            )
        )
        first = next(it, None)
        if first is None:
            nf = len(feature_cols)
            return np.empty((0, nf)), np.empty((0, len(label_cols)))
        fx, fy = first
        x = np.empty((n_rows,) + fx.shape[1:], dtype=fx.dtype)
        y = np.empty((n_rows,) + fy.shape[1:], dtype=fy.dtype)
        pos = 0
        for bx, by in itertools.chain([first], it):
            # Later batches can widen the dtype (e.g. a null in an int64
            # column makes pyarrow yield float64-with-NaN for that batch);
            # promote the output instead of crashing on the assignment.
            if bx.dtype != x.dtype:
                x = x.astype(np.promote_types(x.dtype, bx.dtype))
            if by.dtype != y.dtype:
                y = y.astype(np.promote_types(y.dtype, by.dtype))
            x[pos : pos + len(bx)] = bx
            y[pos : pos + len(by)] = by
            pos += len(bx)
        return x[:pos], y[:pos]
