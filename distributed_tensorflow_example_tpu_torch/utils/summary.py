"""TensorBoard event files without TensorFlow: the port's copy of the
JAX package's ``utils/summary.py``.

- the ``Event``/``Summary``/``GraphDef`` protobuf subset is hand-encoded
  in the wire format (varint, 64-bit and length-delimited fields);
- TFRecord framing (little-endian length, masked CRC32C of the length,
  payload, masked CRC32C of the payload), with the CRC32C in pure Python
  (``masked_crc32c``; an event is tens of bytes, so the table-driven
  loop costs microseconds);
- files are named ``events.out.tfevents.<ts>.<host>`` and open with a
  ``file_version: "brain.Event:2"`` event, as TensorBoard expects.

``SummaryWriter`` is the reference's ``FileWriter`` + ``add_summary``;
``read_event_file`` parses the format back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, Tuple


# --- CRC32C (Castagnoli), as TFRecord frames it ----------------------------


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking (the RecordWriter convention)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire-format encoders -------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _packed_doubles_field(field: int, values) -> bytes:
    """Packed repeated double (wire type 2, consecutive LE doubles)."""
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _key(field, 2) + _varint(len(payload)) + payload


# --- Event / Summary messages (tensorflow/core/util/event.proto) ---------


def encode_scalar_summary(values: dict[str, float]) -> bytes:
    """Summary{ repeated Value{ tag=1, simple_value=2 } value=1 }."""
    out = b""
    for tag, val in values.items():
        value_msg = _bytes_field(1, tag.encode()) + _float_field(2, float(val))
        out += _bytes_field(1, value_msg)
    return out


def encode_histogram_proto(values) -> bytes:
    """HistogramProto{ min=1, max=2, num=3, sum=4, sum_squares=5,
    repeated bucket_limit=6 [packed], repeated bucket=7 [packed] }
    (tensorflow/core/framework/summary.proto).

    Buckets are 30 equal-width bins over [min, max] (right edges in
    ``bucket_limit``), degenerating to one bin when all values are
    equal — TensorBoard renders arbitrary edges, and equal-width bins
    keep the encoder dependency-free. Counts always sum to
    ``len(values)`` (pinned by tests/test_summary.py).

    Non-finite values must not kill the run that is recording them —
    a diverging loss producing an inf grad norm is exactly what the
    histogram exists to show. They are clamped into the finite
    values' range (landing in the edge buckets; NaN counts high);
    an all-non-finite tensor collapses to one bucket at 0."""
    import numpy as np

    v = np.asarray(values, dtype=np.float64).ravel()
    if v.size == 0:
        raise ValueError("cannot encode an empty histogram")
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        lo = hi = 0.0
        vb = np.zeros_like(v)
    else:
        lo, hi = float(finite.min()), float(finite.max())
        vb = np.clip(np.nan_to_num(v, nan=hi, posinf=hi, neginf=lo),
                     lo, hi)
    msg = _double_field(1, lo) + _double_field(2, hi)
    msg += _double_field(3, float(v.size))
    msg += _double_field(4, float(vb.sum()))
    msg += _double_field(5, float(np.square(vb).sum()))
    if hi > lo:
        counts, edges = np.histogram(vb, bins=30, range=(lo, hi))
        limits = edges[1:]
    else:
        counts, limits = np.array([v.size]), np.array([hi])
    msg += _packed_doubles_field(6, limits)
    msg += _packed_doubles_field(7, counts)
    return msg


def encode_histogram_summary(histos: dict) -> bytes:
    """Summary{ repeated Value{ tag=1, histo=5 } } from {tag: array}."""
    out = b""
    for tag, vals in histos.items():
        value_msg = _bytes_field(1, tag.encode()) + _bytes_field(
            5, encode_histogram_proto(vals))
        out += _bytes_field(1, value_msg)
    return out


def encode_node_def(name: str, op: str, inputs: tuple[str, ...] = ()) -> bytes:
    """NodeDef{ name=1, op=2, repeated input=3 } (node_def.proto)."""
    msg = _bytes_field(1, name.encode()) + _bytes_field(2, op.encode())
    for inp in inputs:
        msg += _bytes_field(3, inp.encode())
    return msg


def encode_graph_def(nodes) -> bytes:
    """GraphDef{ repeated node=1, versions=4{producer=1} } from
    (name, op, inputs) triples (graph.proto)."""
    out = b"".join(_bytes_field(1, encode_node_def(*n)) for n in nodes)
    out += _bytes_field(4, _int64_field(1, 27))  # VersionDef.producer
    return out


def mlp_graph_nodes(input_size: int, hidden_sizes, num_classes: int,
                    activation: str, optimizer: str = "sgd"):
    """The training graph as (name, op, inputs) triples, mirroring the
    reference's graph build (the reference example.py:60-129: x/y_
    placeholders, W/b variables, MatMul+Add+activation per layer,
    Softmax output, cross_entropy, accuracy, the optimizer's apply op
    and global_step) so the TensorBoard Graphs tab shows the same
    structure the reference's ``FileWriter(logs_path, graph=...)``
    (example.py:146) published."""
    act_op = {"sigmoid": "Sigmoid", "relu": "Relu", "tanh": "Tanh",
              "gelu": "Gelu"}.get(activation, activation.capitalize())
    opt_op = {"sgd": "ApplyGradientDescent", "momentum": "ApplyMomentum",
              "adam": "ApplyAdam"}.get(optimizer, "ApplyGradientDescent")
    nodes = [
        ("x", "Placeholder", ()),
        ("y_", "Placeholder", ()),
        ("global_step", "VariableV2", ()),
    ]
    sizes = (input_size, *tuple(hidden_sizes), num_classes)
    prev = "x"
    n_layers = len(sizes) - 1
    for i in range(n_layers):
        w, b = f"W{i + 1}", f"b{i + 1}"
        nodes += [(w, "VariableV2", ()), (b, "VariableV2", ())]
        mm, z = f"layer{i + 1}/MatMul", f"z{i + 2}"
        nodes += [(mm, "MatMul", (prev, w)), (z, "Add", (mm, b))]
        if i < n_layers - 1:
            a = f"a{i + 2}"
            nodes.append((a, act_op, (z,)))
            prev = a
        else:
            nodes.append(("y", "Softmax", (z,)))
    nodes += [
        ("cross_entropy", "Mean", ("y", "y_")),
        ("accuracy", "Mean", ("y", "y_")),
        ("train", opt_op, ("cross_entropy", "global_step")),
    ]
    return nodes


def transformer_graph_nodes(num_blocks: int):
    """Graph triples for the transformer family (models/transformer.py)
    — coarse block-level structure for the TB Graphs tab (tensor dims
    are not part of this skeleton, only the op topology)."""
    nodes = [
        ("x", "Placeholder", ()),
        ("y_", "Placeholder", ()),
        ("global_step", "VariableV2", ()),
        ("embed/MatMul", "MatMul", ("x",)),
        ("embed/pos_add", "Add", ("embed/MatMul",)),
    ]
    prev = "embed/pos_add"
    for i in range(num_blocks):
        blk = f"block{i}"
        nodes += [
            (f"{blk}/ln1", "LayerNorm", (prev,)),
            (f"{blk}/attention", "MultiHeadAttention", (f"{blk}/ln1",)),
            (f"{blk}/residual1", "Add", (prev, f"{blk}/attention")),
            (f"{blk}/ln2", "LayerNorm", (f"{blk}/residual1",)),
            (f"{blk}/ffn", "MatMul", (f"{blk}/ln2",)),
            (f"{blk}/residual2", "Add", (f"{blk}/residual1", f"{blk}/ffn")),
        ]
        prev = f"{blk}/residual2"
    nodes += [
        ("lnf", "LayerNorm", (prev,)),
        ("pool", "Mean", ("lnf",)),
        ("y", "Softmax", ("pool",)),
        ("cross_entropy", "Mean", ("y", "y_")),
        ("accuracy", "Mean", ("y", "y_")),
        ("train", "ApplyGradientDescent", ("cross_entropy", "global_step")),
    ]
    return nodes


def encode_event(
    wall_time: float,
    step: int | None = None,
    file_version: str | None = None,
    scalars: dict[str, float] | None = None,
    graph_def: bytes | None = None,
    histograms: dict | None = None,
) -> bytes:
    """Event{ wall_time=1(double), step=2(int64), file_version=3,
    graph_def=4(bytes), summary=5 }."""
    msg = _double_field(1, wall_time)
    if step is not None:
        msg += _int64_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if graph_def is not None:
        msg += _bytes_field(4, graph_def)
    summary = b""
    if scalars:
        summary += encode_scalar_summary(scalars)
    if histograms:
        summary += encode_histogram_summary(histograms)
    if summary:
        msg += _bytes_field(5, summary)
    return msg


def tfrecord_frame(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


class SummaryWriter:
    """Drop-in for the reference's FileWriter + add_summary usage
    (example.py:146, 163), TensorBoard-compatible."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()),
            socket.gethostname(),
            filename_suffix,
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_event(encode_event(time.time(), file_version="brain.Event:2"))

    def _write_event(self, event: bytes) -> None:
        self._f.write(tfrecord_frame(event))

    def add_scalars(self, step: int, values: dict[str, float]) -> None:
        """``writer.add_summary(summary, step)`` equivalent (example.py:163)."""
        self._write_event(encode_event(time.time(), step=step, scalars=values))

    def add_histograms(self, step: int, values: dict) -> None:
        """Write histogram summaries (e.g. grad/param norms) — the
        capability the reference's merged scalar summary never had;
        TensorBoard's Histograms tab reads these."""
        self._write_event(encode_event(time.time(), step=step,
                                       histograms=values))

    def add_graph(self, nodes) -> None:
        """``FileWriter(logdir, graph=...)`` equivalent (example.py:146):
        write the graph record TensorBoard's Graphs tab reads. ``nodes``
        is a list of (name, op, inputs) triples (see mlp_graph_nodes)."""
        self._write_event(encode_event(
            time.time(), graph_def=encode_graph_def(nodes)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# --- reader (tests / tooling) --------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int | float]]:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 5:
            (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_histogram(buf: bytes) -> dict:
    """Decode a HistogramProto (see encode_histogram_proto)."""
    histo = {"min": None, "max": None, "num": None, "sum": None,
             "sum_squares": None, "bucket_limit": [], "bucket": []}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    for hfield, _hw, hval in _parse_fields(buf):
        if hfield in names:
            histo[names[hfield]] = hval
        elif hfield in (6, 7):
            key = "bucket_limit" if hfield == 6 else "bucket"
            vals = [struct.unpack_from("<d", hval, off)[0]
                    for off in range(0, len(hval), 8)]
            histo[key].extend(vals)
    return histo


def read_event_file(path: str):
    """Parse a tfevents file into [{wall_time, step, file_version,
    scalars, histograms, graph_nodes}]."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if len_crc != masked_crc32c(header):
            raise ValueError("length CRC mismatch")
        payload = data[pos + 12 : pos + 12 + length]
        (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if data_crc != masked_crc32c(payload):
            raise ValueError("payload CRC mismatch")
        pos += 12 + length + 4

        ev = {"wall_time": None, "step": None, "file_version": None,
              "scalars": {}, "histograms": {}, "graph_nodes": None}
        for field, _wire, val in _parse_fields(payload):
            if field == 1:
                ev["wall_time"] = val
            elif field == 2:
                ev["step"] = val
            elif field == 3:
                ev["file_version"] = val.decode()
            elif field == 4:
                nodes = []
                for gfield, _gw, gval in _parse_fields(val):
                    if gfield == 1:  # NodeDef
                        name, op, inputs = None, None, []
                        for nfield, _nw, nval in _parse_fields(gval):
                            if nfield == 1:
                                name = nval.decode()
                            elif nfield == 2:
                                op = nval.decode()
                            elif nfield == 3:
                                inputs.append(nval.decode())
                        nodes.append(
                            {"name": name, "op": op, "inputs": inputs})
                ev["graph_nodes"] = nodes
            elif field == 5:
                for sfield, _w, sval in _parse_fields(val):
                    if sfield == 1:
                        tag, simple, histo = None, None, None
                        for vfield, _w2, vval in _parse_fields(sval):
                            if vfield == 1:
                                tag = vval.decode()
                            elif vfield == 2:
                                simple = vval
                            elif vfield == 5:
                                histo = _parse_histogram(vval)
                        if tag is not None and histo is not None:
                            ev["histograms"][tag] = histo
                        elif tag is not None:
                            ev["scalars"][tag] = simple
        events.append(ev)
    return events
