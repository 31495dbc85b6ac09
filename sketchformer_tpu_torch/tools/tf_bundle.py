"""A reader of TF2 checkpoints (tensor bundles) that needs no TensorFlow.

A ``tf.train.Checkpoint`` writes a prefix ``P`` as two kinds of file:

- ``P.index``: a LevelDB-format table (uncompressed blocks) whose keys are
  the variable names (``model/k/.ATTRIBUTES/VARIABLE_VALUE``, the saver's
  ``save_counter``, the ``_CHECKPOINTABLE_OBJECT_GRAPH``) and whose values
  are ``BundleEntryProto`` messages; the key ``""`` holds the
  ``BundleHeaderProto``;
- ``P.data-<shard:05d>-of-<num_shards:05d>``: the tensors' raw bytes, each
  at its entry's ``offset`` for ``size`` bytes, in the header's byte order.

The table and both messages are parsed here by hand (a varint and
length-delimited field reader): the machines that run the port have
neither TensorFlow nor ``protobuf``. The field numbers are those of
``tensorflow/core/protobuf/tensor_bundle.proto``. The entries' ``crc32c``
is not checked: nothing installed beside the port computes it fast.

:class:`TFCheckpointSource` is the tensor source of
``import_reference_weights --tf-ckpt``: ``.shapes`` (name -> shape tuple,
without the object graph), ``in`` and ``[name]`` -> a numpy array.
float32, float64, float16, int32 and int64 come back as they are stored;
bfloat16 (which numpy lacks) comes back widened to float32, which is
exact. A big-endian bundle, a partitioned variable (``slices``), a size
that is not the shape's, a string tensor and a missing shard are refused
with an error that names the variable.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48        # two block handles padded to 40 bytes, the magic
BLOCK_TRAILER_BYTES = 5  # the compression type byte and a crc32c

# DataType enum (tensorflow/core/framework/types.proto) -> stored dtype
DT_STRING = 7
DT_BFLOAT16 = 14
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
          9: np.dtype("<i8"), 19: np.dtype("<f2"), DT_BFLOAT16: np.dtype("<u2")}

# wire types of the protobuf encoding
VARINT, FIXED64, BYTES, FIXED32 = 0, 1, 2, 5


def varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the base-128 varint at ``pos``."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")


def fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a protobuf message: an int
    for a varint or a fixed width, the bytes of a length-delimited field."""
    pos = 0
    while pos < len(buf):
        tag, pos = varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == VARINT:
            value, pos = varint(buf, pos)
        elif wire == FIXED64:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == FIXED32:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == BYTES:
            n, pos = varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > len(buf):
            raise ValueError("truncated protobuf field")
        yield number, value


def _signed(v: int) -> int:
    """An int64 field's varint read as two's complement."""
    return v - (1 << 64) if v >= 1 << 63 else v


# -- the LevelDB-format table ------------------------------------------------

def _block_handle(buf: bytes, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = varint(buf, pos)
    size, pos = varint(buf, pos)
    return (offset, size), pos


def _read_block(data: bytes, handle: Tuple[int, int]) -> bytes:
    offset, size = handle
    end = offset + size
    if end + BLOCK_TRAILER_BYTES > len(data):
        raise ValueError("table block runs past the end of the file")
    if data[end] != 0:
        raise ValueError(f"compressed table block (type {data[end]}); "
                         "a tensor bundle's index is stored uncompressed")
    return data[offset:end]


def _block_entries(block: bytes) -> Tuple[List[Tuple[bytes, bytes]], int]:
    """(the (key, value) entries, the number of restart points) of a block:
    entries of shared and unshared key parts, then the restart offsets and
    their count as fixed32s."""
    if len(block) < 4:
        raise ValueError("table block shorter than its restart count")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 * (n_restarts + 1)
    if limit < 0:
        raise ValueError("table block's restart array overruns it")
    out: List[Tuple[bytes, bytes]] = []
    key = b""
    pos = 0
    while pos < limit:
        shared, pos = varint(block, pos)
        unshared, pos = varint(block, pos)
        n_value, pos = varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > limit:
            raise ValueError("corrupt table block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        out.append((key, block[pos:pos + n_value]))
        pos += n_value
    return out, n_restarts


def read_table(path: str) -> Tuple[List[Tuple[bytes, bytes]], List[int]]:
    """(every (key, value) entry of the table at ``path`` in key order, the
    number of restart points of each data block the index block names)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: shorter than a table footer")
    footer = data[-FOOTER_BYTES:]
    magic = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0]
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a table (magic {magic:#x})")
    _, pos = _block_handle(footer, 0)           # the metaindex: unused
    index_handle, _ = _block_handle(footer, pos)
    index, _ = _block_entries(_read_block(data, index_handle))
    entries: List[Tuple[bytes, bytes]] = []
    restarts: List[int] = []
    for _, value in index:
        handle, _ = _block_handle(value, 0)
        block, n = _block_entries(_read_block(data, handle))
        entries.extend(block)
        restarts.append(n)
    return entries, restarts


# -- the bundle's messages -----------------------------------------------------

def parse_header(buf: bytes) -> Tuple[int, int]:
    """``BundleHeaderProto`` -> (num_shards 1, endianness 2: 0 little,
    1 big)."""
    num_shards, endianness = 1, 0
    for number, value in fields(buf):
        if number == 1:
            num_shards = value
        elif number == 2:
            endianness = value
    return num_shards, endianness


def _shape(buf: bytes) -> Tuple[int, ...]:
    """``TensorShapeProto`` (dim 2: ``Dim`` with size 1) -> a tuple."""
    dims = []
    for number, value in fields(buf):
        if number == 2:
            size = 0
            for n, v in fields(value):
                if n == 1:
                    size = _signed(v)
            dims.append(size)
    return tuple(dims)


def parse_entry(buf: bytes) -> dict:
    """``BundleEntryProto``: dtype 1, shape 2, shard_id 3, offset 4,
    size 5, slices 7 (counted, never read); crc32c 6 is not checked."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
             "slices": 0}
    for number, value in fields(buf):
        if number == 1:
            entry["dtype"] = value
        elif number == 2:
            entry["shape"] = _shape(value)
        elif number == 3:
            entry["shard_id"] = value
        elif number == 4:
            entry["offset"] = _signed(value)
        elif number == 5:
            entry["size"] = _signed(value)
        elif number == 7:
            entry["slices"] += 1
    return entry


# -- the checkpoint ----------------------------------------------------------

def _unescape(text: str) -> str:
    """A text-format string literal's C escapes."""
    return text.encode("latin-1").decode("unicode_escape").encode(
        "latin-1").decode("utf-8")


def latest_prefix(directory: str) -> Optional[str]:
    """``tf.train.latest_checkpoint``: the ``model_checkpoint_path`` of the
    directory's ``checkpoint`` file, joined to the directory when relative,
    or None when there is no such file or its index is missing."""
    path = os.path.join(directory, "checkpoint")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                      f.read(), re.M)
    if m is None:
        return None
    prefix = _unescape(m.group(1))
    if not os.path.isabs(prefix):
        prefix = os.path.join(directory, prefix)
    return prefix if os.path.exists(prefix + ".index") else None


class TFCheckpointSource:
    """The tensors of a TF2 checkpoint directory (its ``checkpoint`` file's
    newest prefix) or prefix, read without TensorFlow."""

    def __init__(self, path: str) -> None:
        prefix = latest_prefix(path) if os.path.isdir(path) else path
        if prefix is None:
            raise FileNotFoundError(f"no TF checkpoint under {path}")
        if not os.path.exists(prefix + ".index"):
            raise FileNotFoundError(f"no TF checkpoint index {prefix}.index")
        self.prefix = prefix
        table, self.block_restarts = read_table(prefix + ".index")
        self.num_shards, self.endianness = 1, 0
        self.entries: Dict[str, dict] = {}
        for key, value in table:
            if key == b"":
                self.num_shards, self.endianness = parse_header(value)
            elif not key.startswith(b"\x00"):
                # (a partitioned variable's slices sit under encoded keys
                # that start with a zero byte; tf.train.list_variables
                # lists none of them either)
                self.entries[key.decode("utf-8")] = parse_entry(value)
        self.shapes = {name: e["shape"] for name, e in self.entries.items()
                       if "CHECKPOINTABLE_OBJECT_GRAPH" not in name}

    def __contains__(self, name: str) -> bool:
        return name in self.shapes

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self.entries:
            raise KeyError(f"{name!r} is not in {self.prefix}")
        e = self.entries[name]
        if self.endianness != 0:
            raise ValueError(f"{name}: stored big-endian; only "
                             "little-endian bundles are read")
        if e["slices"]:
            raise ValueError(f"{name}: a partitioned variable (slices); "
                             "not supported")
        if e["dtype"] == DT_STRING:
            raise ValueError(f"{name}: a string tensor; only numeric "
                             "tensors are read")
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{name}: unsupported dtype enum {e['dtype']}")
        dtype = DTYPES[e["dtype"]]
        numel = int(np.prod(e["shape"], dtype=np.int64))
        if e["size"] != numel * dtype.itemsize:
            raise ValueError(f"{name}: {e['size']} bytes stored, "
                             f"{numel * dtype.itemsize} expected for shape "
                             f"{e['shape']}")
        shard = (f"{self.prefix}.data-{e['shard_id']:05d}-of-"
                 f"{self.num_shards:05d}")
        if not os.path.exists(shard):
            raise FileNotFoundError(f"{name}: shard {shard} is missing")
        with open(shard, "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        if len(raw) != e["size"]:
            raise ValueError(f"{name}: shard {shard} ends before its bytes")
        arr = np.frombuffer(raw, dtype=dtype).reshape(e["shape"])
        if e["dtype"] == DT_BFLOAT16:  # the high half of a float32
            return (arr.astype("<u4") << 16).view("<f4").astype(np.float32)
        return arr.astype(dtype.newbyteorder("="))
