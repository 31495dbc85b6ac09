"""The port's TF2 checkpoint reader (``tools/tf_bundle.py``) against
TensorFlow on the same files, and the importer's ``--tf-ckpt`` path
against the JAX tool's proposals.

One TensorFlow process (``TF_SIDE``) writes the bundles and dumps what
``tf.train.list_variables`` and ``tf.train.load_checkpoint(...).get_tensor``
give for each; the reader then reads the same files in this process:

- ``tok``: the tiny token model's leaves (same-shape groups, one 2-D leaf
  stored transposed), one variable in each dtype and a scalar, a string
  variable, and enough long-named variables that the index holds more
  than one data block; saved twice (``ckpt-1``, ``ckpt-2``);
- ``cont``: the tiny continuous model's leaves;
- ``written/w``: ``tf.train.Checkpoint.write`` (no counter, no
  ``checkpoint`` file);
- ``sliced/s``: ``SaveV2`` of a partitioned variable beside a whole one.
"""

import copy
import importlib.util
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.tools import import_reference_weights as tool
from sketchformer_tpu_torch.tools import tf_bundle
from sketchformer_tpu_torch.tools.tf_bundle import TFCheckpointSource
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "import_reference_weights.py")
TINY = ("d_model=32,num_layers=1,num_heads=2,dff=64,lowerdim=16,"
        "num_queries=2,max_len=32,vocab_size=68,num_classes=5,dropout=0.0")
MODES = {"tok": TINY, "cont": TINY + ",use_continuous=True,num_mixtures=3"}
# one variable of each dtype the reader returns: (TF dtype, shape, what
# the reader gives back)
DTYPED = {"f32": ("float32", (2, 3, 5), np.float32),
          "f64": ("float64", (5, 2, 3), np.float64),
          "f16": ("float16", (3, 5, 2), np.float16),
          "bf16": ("bfloat16", (2, 5, 3), np.float32),
          "i32": ("int32", (5, 3, 2), np.int32),
          "i64": ("int64", (3, 2, 5), np.int64),
          "scalar": ("float32", (), np.float32)}
FILLERS, FILLER_NAME = 300, 1000   # enough index bytes for two data blocks

TF_SIDE = """
import json, os, sys
import numpy as np
import tensorflow as tf

root, spec = sys.argv[1], json.load(open(sys.argv[2]))
values = np.load(sys.argv[3])

def var(key, dtype):
    return tf.Variable(tf.cast(values[key], dtype))

def dump(prefix, tag):
    shapes = dict(tf.train.list_variables(prefix))
    reader = tf.train.load_checkpoint(prefix)
    dtypes = reader.get_variable_to_dtype_map()
    arrays, meta = {}, {}
    for i, name in enumerate(sorted(shapes)):
        if dtypes[name] == tf.string:
            continue
        arr = np.asarray(reader.get_tensor(name))
        dtype = str(arr.dtype)
        if dtype == "bfloat16":
            arr = arr.view(np.uint16)
        arrays[f"t{i}"] = arr
        meta[name] = [f"t{i}", dtype, list(shapes[name])]
    np.savez(os.path.join(root, tag + ".npz"), **arrays)
    json.dump(meta, open(os.path.join(root, tag + ".json"), "w"))

for mode, names in spec["modes"].items():
    tracked = {name: var(name, tf.float32) for name in names}
    if mode == "tok":
        for name, (dtype, _) in spec["dtyped"].items():
            tracked[name] = var(name, dtype)
        tracked["text"] = tf.Variable("a string tensor")
        for i in range(spec["fillers"]):
            tracked[f"x{i:03d}" + "y" * spec["filler_name"]] = tf.Variable(
                np.full((1, 1, 1), i, np.float32))
    ckpt = tf.train.Checkpoint(**tracked)
    first = ckpt.save(os.path.join(root, mode, "ckpt"))
    dump(first, mode + "-1")
    if mode == "tok":
        dump(ckpt.save(os.path.join(root, mode, "ckpt")), mode + "-2")

written = os.path.join(root, "written", "w")
tf.train.Checkpoint(**{name: var(name, dtype) for name, (dtype, _)
                       in spec["dtyped"].items()}).write(written)
dump(written, "written")

tf.raw_ops.SaveV2(prefix=os.path.join(root, "sliced", "s"),
                  tensor_names=["part", "whole"],
                  shape_and_slices=["4 2 0,2:-", ""],
                  tensors=[tf.constant(np.ones((2, 2), np.float32)),
                           tf.constant(np.arange(3.0))])
"""


def _template(mode):
    return tool.dump_template(tool.template_leaves(
        tool.build_config(MODES[mode])))


def _transposed_leaf(template):
    """A 2-D leaf of unequal dims whose shape and transpose no other leaf
    has: stored transposed, only its transpose can match it."""
    shapes = [tuple(s["shape"]) for s in template.values()]
    return next(p for p, s in sorted(template.items())
                if len(s["shape"]) == 2 and s["shape"][0] != s["shape"][1]
                and shapes.count(tuple(s["shape"])) == 1
                and tuple(s["shape"][::-1]) not in shapes)


@pytest.fixture(scope="module")
def tf_side(tmp_path_factory):
    """The bundles TensorFlow wrote, TensorFlow's dumps of them, and the
    values the model leaves were given (path -> array, per mode)."""
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("tensorflow is not installed (it writes the bundles)")
    root = tmp_path_factory.mktemp("tf")
    rng = np.random.default_rng(0)
    values, leaves, names = {}, {}, {}
    for mode in MODES:
        template = _template(mode)
        flip = _transposed_leaf(template)
        leaves[mode], names[mode] = {}, []
        # names that sort in path order: the same-shape groups zip back
        for i, path in enumerate(sorted(template)):
            name = f"{mode}{i:04d}"
            v = rng.standard_normal(template[path]["shape"]).astype(
                np.float32)
            leaves[mode][path] = v
            values[name] = v.T if path == flip else v
            names[mode].append(name)
    for name, (_, shape, _) in DTYPED.items():
        values[name] = (rng.standard_normal(shape) * 100).astype(np.float32)
    spec = {"modes": names, "fillers": FILLERS, "filler_name": FILLER_NAME,
            "dtyped": {k: [d, list(s)] for k, (d, s, _) in DTYPED.items()}}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    np.savez(root / "values.npz", **values)
    r = subprocess.run(
        [sys.executable, "-c", TF_SIDE, str(root), str(root / "spec.json"),
         str(root / "values.npz")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-2000:]
    return root, leaves


def _tf_dump(root, tag):
    """name -> (array as TensorFlow returned it, bf16 widened; its dtype
    name; its listed shape)."""
    with open(root / f"{tag}.json") as f:
        meta = json.load(f)
    out = {}
    with np.load(root / f"{tag}.npz") as data:
        for name, (key, dtype, shape) in meta.items():
            arr = data[key]
            if dtype == "bfloat16":
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            out[name] = (arr, dtype, tuple(shape))
    return out


SOURCES = {"tok-prefix": ("tok/ckpt-1", "tok-1"),
           "tok-dir": ("tok", "tok-2"),
           "cont-dir": ("cont", "cont-1"),
           "written-prefix": ("written/w", "written")}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_reader_equals_tensorflow(source, tf_side):
    root, _ = tf_side
    path, tag = SOURCES[source]
    src = TFCheckpointSource(str(root / path))
    want = _tf_dump(root, tag)
    listed = {n: s for n, (_, _, s) in want.items()}
    # the dump lists every numeric tensor; the reader's shapes add the
    # string ones except the object graph
    assert set(listed) <= set(src.shapes)
    strings = set(src.shapes) - set(listed)
    assert strings == ({"text/.ATTRIBUTES/VARIABLE_VALUE"}
                       if source.startswith("tok") else set())
    assert not any("CHECKPOINTABLE_OBJECT_GRAPH" in n for n in src.shapes)
    assert any("CHECKPOINTABLE_OBJECT_GRAPH" in n for n in src.entries)
    for name, (arr, _, shape) in want.items():
        assert src.shapes[name] == shape, name
        assert name in src
        got = src[name]
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        assert got.tobytes() == arr.tobytes(), name
    if source == "tok-dir":
        assert src.prefix.endswith("ckpt-2")
        assert src["save_counter/.ATTRIBUTES/VARIABLE_VALUE"] == 2
    if source == "written-prefix":
        assert not any("save_counter" in n for n in src.shapes)


@pytest.mark.parametrize("name", sorted(DTYPED))
def test_every_dtype(name, tf_side):
    root, _ = tf_side
    src = TFCheckpointSource(str(root / "written" / "w"))
    tf_dtype, shape, returned = DTYPED[name]
    key = f"{name}/.ATTRIBUTES/VARIABLE_VALUE"
    arr, dtype, _ = _tf_dump(root, "written")[key]
    assert dtype == tf_dtype
    got = src[key]
    assert got.dtype == returned and got.shape == shape
    np.testing.assert_array_equal(got, arr)


def test_the_index_spans_several_blocks(tf_side):
    """The footer's index block names more than one data block, each with
    several restart points."""
    root, _ = tf_side
    src = TFCheckpointSource(str(root / "tok"))
    assert len(src.block_restarts) >= 2
    assert all(n > 1 for n in src.block_restarts)
    fillers = [n for n in src.shapes if n.startswith("x")]
    assert len(fillers) == FILLERS
    assert [src[n][0, 0, 0] for n in sorted(fillers)] == list(range(FILLERS))


def _jax_propose():
    spec = importlib.util.spec_from_file_location("jax_import_tool", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._propose_mapping


@pytest.mark.parametrize("mode", sorted(MODES))
def test_proposals_and_tf_ckpt_import(mode, tf_side, tmp_path):
    root, leaves = tf_side
    ckpt = str(root / mode)
    src = TFCheckpointSource(ckpt)
    template = _template(mode)
    ours = tool.propose_mapping(copy.deepcopy(template), src)
    assert ours == _jax_propose()(copy.deepcopy(template), src)
    assert all(s["ref"] for s in ours.values())
    assert ours[_transposed_leaf(template)]["transpose"] == [1, 0]
    assert any(s.get("auto_ambiguous") for s in ours.values())

    tmpl = str(tmp_path / "map.json")
    assert tool.main(["--hparams", MODES[mode], "--tf-ckpt", ckpt,
                      "--dump-template", tmpl]) == 0
    with open(tmpl) as f:
        assert json.load(f) == ours
    out = str(tmp_path / "run")
    assert tool.main(["--hparams", MODES[mode], "--tf-ckpt", ckpt,
                      "--mapping", tmpl, "--out", out]) == 0
    params = CheckpointManager(out).load_state_dict()["params"]
    assert len(params) == len(leaves[mode])
    for path, want in leaves[mode].items():
        assert torch.equal(params[path.replace("/", ".")],
                           torch.from_numpy(want)), path


NO_TF = """
import hashlib, json, sys
sys.modules["tensorflow"] = None
sys.modules["google.protobuf"] = None
from sketchformer_tpu_torch.tools.tf_bundle import TFCheckpointSource
src = TFCheckpointSource(sys.argv[1])
print(json.dumps({n: hashlib.sha256(src[n].tobytes()).hexdigest()
                  for n in src.shapes if n != "text/.ATTRIBUTES/VARIABLE_VALUE"}))
print("tensorflow" in sys.modules and sys.modules["tensorflow"] is not None)
"""


def test_the_reader_needs_no_tensorflow(tf_side):
    import hashlib

    root, _ = tf_side
    r = subprocess.run([sys.executable, "-c", NO_TF, str(root / "tok")],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "False"
    src = TFCheckpointSource(str(root / "tok"))
    assert json.loads(lines[-2]) == {
        n: hashlib.sha256(src[n].tobytes()).hexdigest()
        for n in src.shapes if n != "text/.ATTRIBUTES/VARIABLE_VALUE"}


# -- refusals ----------------------------------------------------------------

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number, wire, payload):
    if wire == 0:
        return _varint(number << 3) + _varint(payload)
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _block(entries, restart_every):
    """A table block: prefix-compressed entries, restart offsets, count."""
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_every:
            while (shared < min(len(prev), len(key))
                   and prev[shared] == key[shared]):
                shared += 1
        else:
            restarts.append(len(out))
        out += (_varint(shared) + _varint(len(key) - shared)
                + _varint(len(value)) + key[shared:] + value)
        prev = key
    restarts = restarts or [0]
    out += b"".join(struct.pack("<I", r) for r in restarts)
    return bytes(out + struct.pack("<I", len(restarts)))


def _write_bundle(prefix, header, entries, data):
    """A one-block table of the header and (name, entry) pairs, restarting
    every two entries, and its one shard of ``data``."""
    rows = [(b"", header)] + sorted((k.encode(), v) for k, v in entries)
    blocks = bytearray()
    handles = []
    for block in (_block(rows, 2), _block([], 1)):
        handles.append(_varint(len(blocks)) + _varint(len(block)))
        blocks += block + b"\0\0\0\0\0"
    index = _block([(rows[-1][0], handles[0])], 1)
    index_handle = _varint(len(blocks)) + _varint(len(index))
    blocks += index + b"\0\0\0\0\0"
    footer = (handles[1] + index_handle).ljust(40, b"\0") + struct.pack(
        "<Q", tf_bundle.TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(blocks) + footer)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(data)


def _entry(dtype, shape, offset, size):
    dims = b"".join(_field(2, 2, _field(1, 0, d)) for d in shape)
    return (_field(1, 0, dtype) + _field(2, 2, dims) + _field(4, 0, offset)
            + _field(5, 0, size))


def test_handwritten_table_reads(tmp_path):
    """Prefix-compressed keys across restart points, in a table this file
    writes by hand (the refusals below use the same writer)."""
    prefix = str(tmp_path / "h")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(4, dtype=np.int64)
    _write_bundle(prefix, _field(1, 0, 1), [
        ("layer/a", _entry(1, (2, 3), 0, 24)),
        ("layer/ab", _entry(9, (4,), 24, 32)),
        ("layer/abc", _entry(1, (2, 3), 0, 24))], a.tobytes() + b.tobytes())
    src = TFCheckpointSource(prefix)
    assert src.shapes == {"layer/a": (2, 3), "layer/ab": (4,),
                          "layer/abc": (2, 3)}
    np.testing.assert_array_equal(src["layer/a"], a)
    np.testing.assert_array_equal(src["layer/ab"], b)
    assert src.block_restarts == [2]


def _refusal(case, root, tmp_path):
    """(source, variable) for a bundle the reader must refuse."""
    if case == "string":
        return (TFCheckpointSource(str(root / "tok")),
                "text/.ATTRIBUTES/VARIABLE_VALUE")
    if case == "slices":
        return TFCheckpointSource(str(root / "sliced" / "s")), "part"
    if case == "missing_shard":
        prefix = str(tmp_path / "copy")
        shutil.copy(root / "tok" / "ckpt-1.index", prefix + ".index")
        return TFCheckpointSource(prefix), "f32/.ATTRIBUTES/VARIABLE_VALUE"
    prefix = str(tmp_path / case)
    header = _field(1, 0, 1) + (_field(2, 0, 1) if case == "big_endian"
                                else b"")
    size = 20 if case == "size" else 24
    _write_bundle(prefix, header, [("w", _entry(1, (2, 3), 0, size))],
                  bytes(24))
    return TFCheckpointSource(prefix), "w"


@pytest.mark.parametrize("case", ["big_endian", "slices", "size", "string",
                                  "missing_shard"])
def test_refusals_name_the_variable(case, tf_side, tmp_path):
    src, name = _refusal(case, tf_side[0], tmp_path)
    assert name in src.shapes
    error = FileNotFoundError if case == "missing_shard" else ValueError
    with pytest.raises(error, match=name.split("/")[0]):
        src[name]


def test_sliced_bundle_lists_what_tensorflow_lists(tf_side):
    """A partitioned variable's encoded slice keys are not listed."""
    src = TFCheckpointSource(str(tf_side[0] / "sliced" / "s"))
    assert src.shapes == {"part": (4, 2), "whole": (3,)}
    np.testing.assert_array_equal(src["whole"], np.arange(3.0))
