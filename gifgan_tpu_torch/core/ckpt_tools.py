"""Checkpoint portability tools (gifgan_tpu/core/ckpt_tools.py).

The reference ships a checkpoint-format migration tool
(utils/downgrade_tf_checkpoint.py: re-save a V2 TF checkpoint as V1 for
older runtimes). The equivalents for the step-dir format that both
packages write (core/checkpoint.py):

  - export_flat: a checkpoint step -> ONE self-describing .npz (portable to
    any numpy-speaking consumer; the cross-version "downgrade"),
  - import_flat: that .npz -> a checkpoint step dir,
  - inspect: list keys/shapes/dtypes (the `print_tensors_in_checkpoint` of
    this world).

They work on the flat arrays as stored, in the JAX package's layouts, so a
.npz or a step that either package wrote passes through either. The TF
readers and the V1 writer below are numpy and struct code, the same as
the JAX package's; `import_reference_dcgan` returns port tensors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.tree import unflatten


def export_flat(ckpt_dir: str, out_path: str,
                step: Optional[int] = None) -> str:
    flat = ckpt.load_flat(ckpt_dir, step)
    step = step if step is not None else ckpt.latest_step(ckpt_dir)
    meta = json.dumps({"format": "gifgan_tpu.flat/1", "step": step,
                       "keys": sorted(flat)})
    np.savez_compressed(out_path, __meta__=np.frombuffer(
        meta.encode(), np.uint8), **flat)
    return out_path


def import_flat(npz_path: str, ckpt_dir: str,
                step: Optional[int] = None) -> str:
    with np.load(npz_path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    step = step if step is not None else meta.get("step", 0)
    # a tree shaped like the flat keys (nested dicts), saved as it is
    return ckpt.save(ckpt_dir, step, unflatten(flat))


def inspect(ckpt_dir: str, step: Optional[int] = None) -> str:
    flat = ckpt.load_flat(ckpt_dir, step)
    lines = []
    total = 0
    for k in sorted(flat):
        v = flat[k]
        total += v.size
        lines.append(f"{k}  {v.shape}  {v.dtype}")
    lines.append(f"total parameters: {total:,}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Raw TensorFlow checkpoint reader — NO TensorFlow dependency.
#
# The reference trains with tf.train.Saver (model.py:428-452) and even ships
# a V2->V1 downgrade tool (utils/downgrade_tf_checkpoint.py). To import its
# artifacts, this parses the two on-disk formats directly:
#   * V2 "bundle": {prefix}.index is a leveldb-format table whose "" key is
#     a BundleHeaderProto and whose other keys are tensor names mapping to
#     BundleEntryProto (dtype/shape/shard/offset/size); raw bytes live in
#     {prefix}.data-NNNNN-of-MMMMM.
#   * V1 "TensorSlice": {prefix} itself is one leveldb table whose values
#     are SavedTensorSlices protos with the tensor data embedded as
#     TensorProto (tensor_content or packed typed fields).
# Only the wire-format subset these files use is implemented (varint +
# length-delimited + fixed32/64; prefix-compressed table blocks; no
# compression — tf's tensor_bundle writes kNoCompression).
# ---------------------------------------------------------------------------

import struct as _struct

_TF_MAGIC = 0xdb4775248b80fb57
_TF_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16,
    22: np.uint32, 23: np.uint64,
}


def _varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf):
    """Yield (field_number, wire_type, value) over a serialized message.
    wire 0 -> varint int, 2 -> bytes, 5 -> fixed32, 1 -> fixed64."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = _struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = _struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf):
    """TensorShapeProto: field 2 repeated Dim{field 1 size varint}."""
    dims = []
    for f, _, v in _proto_fields(buf):
        if f == 2:
            size = 1
            for f2, _, v2 in _proto_fields(v):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _read_block(data, offset, size):
    """One table block: prefix-compressed entries + restart array; the
    1-byte compression type + 4-byte crc trailer follow `size`."""
    comp = data[offset + size]
    if comp != 0:
        raise ValueError(
            f"compressed table block (type {comp}) — tf bundles are "
            "written uncompressed; snappy blocks unsupported")
    block = data[offset:offset + size]
    n_restarts = _struct.unpack("<I", block[-4:])[0]
    end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    out = []
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        out.append((key, block[pos:pos + vlen]))
        pos += vlen
    return out


def _read_table(path):
    """All (key, value) pairs of a leveldb-format table file."""
    data = open(path, "rb").read()
    magic = _struct.unpack("<Q", data[-8:])[0]
    if magic != _TF_MAGIC:
        raise ValueError(f"{path}: not a tensorflow table (magic {magic:#x})")
    footer = data[-48:-8]
    pos = 0
    _, pos = _varint(footer, pos)      # metaindex offset
    _, pos = _varint(footer, pos)      # metaindex size
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)
    entries = []
    for _, handle in _read_block(data, idx_off, idx_size):
        h = 0
        off, h = _varint(handle, h)
        size, h = _varint(handle, h)
        entries.extend(_read_block(data, off, size))
    return entries


def _tensorproto_to_array(buf):
    """TensorProto subset: dtype=1, tensor_shape=2, tensor_content=4,
    packed/typed value fields 5-11."""
    dtype_enum, shape, content = 1, None, None
    typed = {5: [], 6: [], 7: [], 10: [], 11: []}
    for f, wire, v in _proto_fields(buf):
        if f == 1:
            dtype_enum = v
        elif f == 2:
            shape = _parse_shape(v)
        elif f == 4:
            content = v
        elif f in typed and wire == 2:  # packed
            typed[f].append(("packed", v))
        elif f in typed:
            typed[f].append(("one", v))
    np_dtype = _TF_DTYPES.get(dtype_enum)
    if np_dtype is None:
        raise ValueError(f"unsupported TF dtype enum {dtype_enum}")
    if content is not None:
        arr = np.frombuffer(content, np_dtype).copy()
        return arr.reshape(shape) if shape is not None else arr
    def signed(x):
        # proto int32/int64/bool varints are two's-complement 64-bit
        return x - (1 << 64) if x >= (1 << 63) else x

    vals = []
    for f, entries2 in typed.items():
        for kind, v in entries2:
            if kind == "one":
                if f == 5:    # float_val: wire 5 fixed32
                    vals.append(_struct.unpack("<f", _struct.pack("<I", v))[0])
                elif f == 6:  # double_val: wire 1 fixed64
                    vals.append(_struct.unpack("<d", _struct.pack("<Q", v))[0])
                else:
                    vals.append(signed(v))
            else:
                if f == 5:
                    vals.extend(np.frombuffer(v, np.float32).tolist())
                elif f == 6:
                    vals.extend(np.frombuffer(v, np.float64).tolist())
                else:
                    pos = 0
                    while pos < len(v):
                        x, pos = _varint(v, pos)
                        vals.append(signed(x))
    arr = np.asarray(vals, np_dtype)
    return arr.reshape(shape) if shape is not None else arr


def read_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """{variable_name: array} from a TF checkpoint, V2 bundle or V1
    TensorSlice, without TensorFlow. Slices ('part N of M' variables) are
    not reassembled — the reference never shards variables."""
    if os.path.exists(prefix + ".index"):
        return _read_tf_v2(prefix)
    if os.path.exists(prefix):
        return _read_tf_v1(prefix)
    raise FileNotFoundError(f"no TF checkpoint at {prefix}(.index)")


def _read_tf_v2(prefix: str) -> Dict[str, np.ndarray]:
    import glob as _glob

    entries = _read_table(prefix + ".index")
    shards = sorted(_glob.glob(prefix + ".data-*-of-*"))
    shard_bytes = [open(p, "rb").read() for p in shards]
    out = {}
    for key, value in entries:
        if key == b"":
            continue  # BundleHeaderProto
        dtype_enum, shape, shard, offset, size = 1, (), 0, 0, 0
        for f, wire, v in _proto_fields(value):
            if f == 1:
                dtype_enum = v
            elif f == 2:
                shape = _parse_shape(v)
            elif f == 3:
                shard = v
            elif f == 4:
                offset = v
            elif f == 5:
                size = v
        np_dtype = _TF_DTYPES.get(dtype_enum)
        if np_dtype is None:
            raise ValueError(f"{key!r}: unsupported TF dtype {dtype_enum}")
        raw = shard_bytes[shard][offset:offset + size]
        out[key.decode()] = np.frombuffer(raw, np_dtype).reshape(shape).copy()
    return out


def _read_tf_v1(prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    shapes = {}
    entries = _read_table(prefix)
    for key, value in entries:
        if key != b"":
            continue
        # "" -> SavedTensorSlices{meta=1: SavedTensorSliceMeta{
        #        tensor=1 repeated: SavedSliceMeta{name=1, shape=2}}}
        for f, _, v in _proto_fields(value):
            if f != 1:
                continue
            for f2, _, v2 in _proto_fields(v):
                if f2 != 1:
                    continue
                name, shape = None, ()
                for f3, _, v3 in _proto_fields(v2):
                    if f3 == 1:
                        name = v3.decode()
                    elif f3 == 2:
                        shape = _parse_shape(v3)
                if name is not None:
                    shapes[name] = shape
    for key, value in entries:
        if key == b"":
            continue
        # SavedTensorSlices: field 2 = SavedSlice{name=1, slice=2, data=3}
        for f, _, v in _proto_fields(value):
            if f != 2:
                continue
            name, tensor = None, None
            for f2, _, v2 in _proto_fields(v):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 3:
                    tensor = _tensorproto_to_array(v2)
            if name is not None and tensor is not None:
                # slice TensorProtos omit tensor_shape; use the meta's
                out[name] = tensor.reshape(shapes.get(name, tensor.shape))
    return out


def import_reference_dcgan(prefix: str, cfg, scope: str = "",
                           device=None):
    """Map a reference-trained DCGAN TF checkpoint onto the port's trees.

    Name mapping (reference model.py:296-324 generator, :268-279
    discriminator; ops.py linear 'Matrix'/'bias', conv/deconv 'w'/'biases',
    contrib batch_norm 'gamma/beta/moving_mean/moving_variance'):
      g_h0_lin/Matrix -> generator.h0_lin.w
      g_h{i}/w        -> generator.h{i}_deconv.w
      g_bn{i}/*       -> generator.bn{i} params/state
      d_h{i}_conv/w   -> discriminator.h{i}_conv.w
      d_h3_lin/Matrix -> discriminator.h3_lin.w
    TF's layouts are the JAX package's (deconv `[h, w, out, in]`, conv
    HWIO), so the arrays are keyed as a JAX checkpoint and go through
    core/interop.py from_jax_flat onto `device` (None: the card), as every
    checkpoint does. scope: optional enclosing TF scope to strip (the
    reference nests the image GAN under 'image_gan/' in VID_DCGAN,
    z_model_lib.py:117-134). `cfg` is unused: the shapes are the file's.
    Returns (params, state), each {"generator", "discriminator"}, as
    cli.py _load_dcgan_from_run gives them.
    """
    flat = read_tf_checkpoint(prefix)
    if scope:
        pre = scope.rstrip("/") + "/"
        flat = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}

    def a(name):
        if name not in flat:
            raise KeyError(f"reference checkpoint missing variable {name}; "
                           f"has e.g. {sorted(flat)[:5]}")
        return flat[name]

    out = {}

    def layer(net, ours, theirs, w="w", b="biases"):
        out[f"params/{net}/{ours}/w"] = a(f"{theirs}/{w}")
        out[f"params/{net}/{ours}/b"] = a(f"{theirs}/{b}")

    def bn(net, ours, theirs):
        out[f"params/{net}/{ours}/scale"] = a(f"{theirs}/gamma")
        out[f"params/{net}/{ours}/bias"] = a(f"{theirs}/beta")
        out[f"state/{net}/{ours}/mean"] = a(f"{theirs}/moving_mean")
        out[f"state/{net}/{ours}/var"] = a(f"{theirs}/moving_variance")

    layer("generator", "h0_lin", "g_h0_lin", "Matrix", "bias")
    for i in range(4):
        bn("generator", f"bn{i}", f"g_bn{i}")
    for i in range(1, 5):
        layer("generator", f"h{i}_deconv", f"g_h{i}")
    layer("discriminator", "h3_lin", "d_h3_lin", "Matrix", "bias")
    for i in range(4):
        layer("discriminator", f"h{i}_conv", f"d_h{i}_conv")
    for i in range(1, 4):
        bn("discriminator", f"bn{i}", f"d_bn{i}")
    tree = interop.from_jax_flat(out, device)
    return tree["params"], tree["state"]


# ---------------------------------------------------------------------------
# V1 TensorSlice WRITER — the reverse of _read_tf_v1, completing parity with
# the reference's V2->V1 migration tool (utils/downgrade_tf_checkpoint.py:
# 32-44: load a V2 checkpoint, re-save with write_version=1). No TensorFlow
# dependency: serializes the SavedTensorSlices protos and the leveldb table
# container (uncompressed blocks, masked crc32c) by hand.
# ---------------------------------------------------------------------------

_TF_DTYPE_ENUMS = {np.dtype(v): k for k, v in _TF_DTYPES.items()}

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """leveldb's masked crc32c (type byte included by the caller)."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _emit_varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _field_varint(num: int, val: int) -> bytes:
    return _emit_varint(num << 3) + _emit_varint(val)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _emit_varint((num << 3) | 2) + _emit_varint(len(payload)) + payload


def _shape_proto(shape) -> bytes:
    return b"".join(
        _field_bytes(2, _field_varint(1, int(s))) for s in shape)


def _slice_proto(shape) -> bytes:
    # TensorSliceProto: repeated Extent{start=1, length=2} — full extents
    return b"".join(
        _field_bytes(1, _field_varint(1, 0) + _field_varint(2, int(s)))
        for s in shape)


def _tensor_proto(arr: np.ndarray) -> bytes:
    enum = _TF_DTYPE_ENUMS.get(arr.dtype)
    if enum is None:
        raise ValueError(f"no TF dtype enum for {arr.dtype}")
    content = np.ascontiguousarray(arr).tobytes()
    return (_field_varint(1, enum) + _field_bytes(2, _shape_proto(arr.shape))
            + _field_bytes(4, content))


def _write_block(f, entries) -> tuple:
    """One uncompressed table block; returns its BlockHandle (offset, size).
    Every entry is its own restart point (shared=0) — valid leveldb."""
    off = f.tell()
    body = b""
    restarts = []
    for key, value in entries:
        restarts.append(len(body))
        body += (_emit_varint(0) + _emit_varint(len(key))
                 + _emit_varint(len(value)) + key + value)
    if not restarts:
        restarts = [0]
    body += b"".join(_struct.pack("<I", r) for r in restarts)
    body += _struct.pack("<I", len(restarts))
    f.write(body)
    f.write(bytes([0]))  # compression type: none
    f.write(_struct.pack("<I", _masked_crc(body + bytes([0]))))
    return off, len(body)


def _handle(off: int, size: int) -> bytes:
    return _emit_varint(off) + _emit_varint(size)


def write_tf_checkpoint_v1(arrays: Dict[str, np.ndarray], path: str) -> str:
    """Write {name: array} as a TF V1 TensorSlice checkpoint file (the
    format tf.train.Saver(write_version=1) produced). Round-trips through
    read_tf_checkpoint; data keys are name + NUL + full-slice spec (sorted,
    unique — the property the table format needs)."""
    meta_tensors = b""
    data_entries = []
    for name in sorted(arrays):
        arr = np.asarray(arrays[name])
        enum = _TF_DTYPE_ENUMS.get(arr.dtype)
        if enum is None:
            raise ValueError(f"{name}: no TF dtype enum for {arr.dtype}")
        meta_tensors += _field_bytes(
            1, _field_bytes(1, name.encode())
            + _field_bytes(2, _shape_proto(arr.shape))
            + _field_varint(3, enum)
            + _field_bytes(4, _slice_proto(arr.shape)))
        saved_slice = (_field_bytes(1, name.encode())
                       + _field_bytes(2, _slice_proto(arr.shape))
                       + _field_bytes(3, _tensor_proto(arr)))
        key = name.encode() + b"\x00" + b":".join(
            b"0,%d" % s for s in arr.shape)
        data_entries.append((key, _field_bytes(2, saved_slice)))
    header = _field_bytes(1, meta_tensors)  # SavedTensorSlices{meta=1}
    entries = [(b"", header)] + sorted(data_entries)

    with open(path, "wb") as f:
        data_handle = _handle(*_write_block(f, entries))
        meta_handle = _handle(*_write_block(f, []))   # empty metaindex
        index_handle = _handle(*_write_block(
            f, [(entries[-1][0] + b"\xff", data_handle)]))
        footer = meta_handle + index_handle
        footer += bytes(40 - len(footer))
        footer += _struct.pack("<Q", _TF_MAGIC)
        f.write(footer)
    return path


def downgrade_checkpoint(in_prefix: str, out_path: str) -> str:
    """V2 bundle (or V1) -> V1 TensorSlice file, the reference's
    downgrade_tf_checkpoint.py behavior without TensorFlow."""
    return write_tf_checkpoint_v1(read_tf_checkpoint(in_prefix), out_path)
