"""The port's Arrow IPC (feather) reader and writer
(``himo_tpu_torch/io/arrow.py``) against pandas and pyarrow, on the CPU.

The reader reads what pandas writes: 100,000 rows are two record batches
(65,536 and 34,464 rows), every buffer an LZ4 frame, the schema carrying
the ``pandas`` metadata; and what ``pyarrow.ipc`` writes uncompressed.
Every value must come back exactly, in pandas' dtype. A ZSTD file, a
column with nulls, a dictionary-encoded column and an unknown type raise
with the field's name. What the writer writes, pandas must read back to
the same columns, dtypes and values. The committed LZ4 fixture
(``tests/data/lz4_fixture.feather``) must read to its generator's columns
through either LZ4 decoder."""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

from himo_tpu_torch import native
from himo_tpu_torch.io import arrow, lz4

sys.path.insert(0, str(Path(__file__).resolve().parent / "data"))
import lz4_fixture  # noqa: E402

ROWS = 100_000


def _columns(rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "f16": rng.normal(0, 1, rows).astype(np.float16),
        "f32": np.round(rng.normal(0, 1, rows), 2).astype(np.float32),
        "f64": rng.normal(0, 1, rows),
        "b": rng.random(rows) < 0.3,
    }
    for bits in (8, 16, 32, 64):
        info = np.iinfo(f"int{bits}")
        cols[f"i{bits}"] = rng.integers(info.min, info.max, rows, dtype=f"int{bits}",
                                        endpoint=True)
        cols[f"u{bits}"] = rng.integers(0, np.iinfo(f"uint{bits}").max, rows,
                                        dtype=f"uint{bits}", endpoint=True)
    return cols


def _strings(rows=ROWS, seed=1):
    rng = np.random.default_rng(seed)
    words = np.array(["", "car", "truck", "ünïcødé", "x" * 300])
    return words[rng.integers(0, len(words), rows)]


def _assert_same(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        if w.dtype == object:
            assert got[name].dtype == object and list(got[name]) == list(w), name
        else:
            assert got[name].dtype == w.dtype, name
            assert got[name].tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def pandas_file(tmp_path_factory):
    df = pd.DataFrame({**_columns(), "s": _strings()})
    path = tmp_path_factory.mktemp("arrow") / "frame.feather"
    df.to_feather(path)
    return path, df


def test_pandas_file_is_what_the_reader_must_take(pandas_file):
    path, _ = pandas_file
    reader = ipc.open_file(path)
    assert [reader.get_batch(i).num_rows for i in range(reader.num_record_batches)] == \
        [65_536, ROWS - 65_536]
    assert b"pandas" in reader.schema.metadata
    assert reader.schema.field("s").type == pa.large_string()
    assert path.read_bytes().count(lz4.MAGIC.to_bytes(4, "little")) > 10  # LZ4 frames


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_reads_pandas_multi_batch_lz4_file(pandas_file, decoder, monkeypatch):
    if decoder == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler here")
    path, df = pandas_file
    _assert_same(arrow.read_feather(path), df)
    _assert_same(arrow.read_feather(path.read_bytes()), df)


@pytest.mark.parametrize("compression", [None, "lz4"])
def test_reads_pyarrow_ipc_files(tmp_path, compression):
    """utf8 with int32 offsets (pandas writes large_string), several small
    batches, an empty batch, and columns of every reader type."""
    cols = _columns(5_000, seed=2)
    table = pa.table({**cols, "s": pa.array(_strings(5_000), type=pa.string()),
                      "ls": pa.array(_strings(5_000, 3), type=pa.large_string())})
    path = tmp_path / "t.arrow"
    options = ipc.IpcWriteOptions(compression=compression)
    with ipc.new_file(path, table.schema, options=options) as writer:
        for batch in table.to_batches(max_chunksize=1_500):
            writer.write_batch(batch)
        writer.write_batch(pa.RecordBatch.from_pylist([], schema=table.schema))
    got = arrow.read_feather(path)
    _assert_same(got, table.to_pandas())
    empty = tmp_path / "empty.arrow"
    with ipc.new_file(empty, table.schema):
        pass
    for name, values in arrow.read_feather(empty).items():
        assert len(values) == 0 and values.dtype == got[name].dtype, name


@pytest.mark.parametrize("case", ["zstd", "nulls", "dictionary", "timestamp"])
def test_refuses_what_it_does_not_read(tmp_path, case):
    path = tmp_path / f"{case}.arrow"
    options = ipc.IpcWriteOptions(compression="zstd" if case == "zstd" else None)
    column = {
        "zstd": pa.array(np.arange(1_000, dtype=np.float32)),
        "nulls": pa.array([1.0, None, 3.0], type=pa.float32()),
        "dictionary": pa.array(["a", "b", "a"]).dictionary_encode(),
        "timestamp": pa.array(np.array([0, 1, 2], dtype="datetime64[ns]")),
    }[case]
    table = pa.table({f"col_{case}": column})
    with ipc.new_file(path, table.schema, options=options) as writer:
        writer.write_table(table)
    match = {"zstd": "ZSTD", "nulls": "nulls", "dictionary": "dictionary",
             "timestamp": "Timestamp"}[case]
    with pytest.raises(NotImplementedError, match=f"col_{case}.*{match}"):
        arrow.read_feather(path)


def test_refuses_a_file_that_is_not_arrow(tmp_path):
    with pytest.raises(ValueError, match="ARROW1"):
        arrow.read_feather(b"PAR1" + bytes(40))


@pytest.mark.parametrize("rows", [0, 1, 70_000])
def test_writer_output_reads_back_in_pandas(tmp_path, rows):
    cols = _columns(rows, seed=5)
    path = tmp_path / "w.feather"
    arrow.write_feather(cols, path)
    back = pd.read_feather(path)
    assert list(back.columns) == list(cols)
    for name, values in cols.items():
        assert back[name].dtype == values.dtype, name
        assert back[name].to_numpy().tobytes() == values.tobytes(), name
    reader = ipc.open_file(path)
    assert reader.num_record_batches == 1 and reader.schema.metadata is None
    _assert_same(arrow.read_feather(path), back)


@pytest.mark.parametrize("rows", [0, 1, 70_000])
def test_writer_string_columns_read_back_in_pandas(tmp_path, rows):
    """Object arrays of ``str`` go out as large utf8 (int64 offsets), as
    pandas writes them: pandas reads the same strings back, and so does
    ``read_feather``, as object arrays."""
    strings = _strings(rows, seed=6).astype(object)
    cols = {"uuid": strings, "n": np.arange(rows, dtype=np.int64),
            "category": strings[::-1].copy()}
    path = tmp_path / "w.feather"
    arrow.write_feather(cols, path)
    schema = ipc.open_file(path).schema
    assert [schema.field(k).type for k in cols] == [pa.large_string(), pa.int64(),
                                                    pa.large_string()]
    back = pd.read_feather(path)
    for name in ("uuid", "category"):
        assert list(back[name]) == list(cols[name]), name
    assert back["n"].to_numpy().tobytes() == cols["n"].tobytes()
    got = arrow.read_feather(path)
    for name in ("uuid", "category"):
        assert got[name].dtype == object and list(got[name]) == list(cols[name]), name


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(NotImplementedError, match="'s'"):
        arrow.write_feather({"s": np.array(["a"])}, tmp_path / "w.feather")
    with pytest.raises(ValueError, match="shapes"):
        arrow.write_feather({"a": np.zeros(3), "b": np.zeros(4)}, tmp_path / "w.feather")


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_committed_fixture_reads_to_its_generators_columns(decoder, monkeypatch):
    """The fixture is what pandas writes (two batches of linked-block LZ4
    frames); either decoder reads it to the generator's columns, byte for
    byte."""
    if decoder == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler here")
    reader = ipc.open_file(lz4_fixture.PATH)
    assert [reader.get_batch(i).num_rows for i in range(reader.num_record_batches)] == \
        [65_536, lz4_fixture.ROWS - 65_536]
    got = arrow.read_feather(lz4_fixture.PATH)
    want = lz4_fixture.columns()
    assert list(got) == list(want)
    for name, values in want.items():
        assert got[name].dtype == values.dtype and got[name].tobytes() == values.tobytes()
    assert pd.read_feather(lz4_fixture.PATH).equals(pd.DataFrame(want))
    assert lz4_fixture.PATH.stat().st_size < 64 << 10
