"""Kaldi nnet1 text-format parsers (numpy), as fastdnn_tpu/formats/kaldi_text.py.

Three text formats, those the reference's Java layer accepts:

1. Network file: a sequence of `<AffineTransform> <out> <in>` components,
   each followed by `out` rows of `in` weights and one bias row of `out`
   values; activation markers like `<Sigmoid>`/`<Softmax>` and
   bracket-only lines are skipped.  A `<LinearTransform> <k> <in>` (`k`
   rows of `in` weights, no bias) followed by an `<AffineTransform> <out>
   <k>` is one low-rank layer (a RawLayer with that bottleneck), as an
   SVD-restructured net stores it.
2. Feature-transform file: bracketed `[ ... ]` blocks; with three blocks
   the first is a `<Splice>` block and is dropped; the other two are the
   shift and scale vectors, which must match the network's input dim.
   Each input frame is transformed as `(x + shift) * scale`.
3. Feature file: `utterance-id [\\n frame rows... ]` blocks.

The parsers give the JAX package's results on the same text: the same
float conversions (network rows through Python floats, feature tokens
through libc strtof) and the same rejections.  `load_features_text` keeps
the Python parser, which mirrors the native loop statement for statement,
as the JAX package keeps it beside its native reader; the port's native
text reader (formats/native.read_features_text) is held equal to it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np

from .binary import RawLayer, RawNetwork

_BRACKET_BLOCK = re.compile(r"\[(.+?)\]", re.DOTALL)

# Feature tokens are read by libc strtof, bound through ctypes: its token
# syntax, its leading-isspace skip (which includes \v/\f and can cross a \n
# they precede), nan(char-seq) payloads and correctly rounded decimal -> f32.
# The regex below is the fallback where no libc can be opened: the same
# token grammar, parsed as a Python float (double), which can differ from
# strtof's single rounding by 1 ulp on adversarial decimals.
try:
    import ctypes

    _LIBC = ctypes.CDLL(None, use_errno=True)
    _C_STRTOF = _LIBC.strtof
    _C_STRTOF.restype = ctypes.c_float
    _C_STRTOF.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
except Exception:  # pragma: no cover - non-POSIX fallback
    _C_STRTOF = None

_CFLOAT = re.compile(
    r"""[+-]?(?:
        0[xX](?:[0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?|\.[0-9a-fA-F]+)(?:[pP][+-]?[0-9]+)?
      | (?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?
      | [iI][nN][fF](?:[iI][nN][iI][tT][yY])?
      | [nN][aA][nN](?:\([0-9a-zA-Z_]*\))?
    )""",
    re.VERBOSE,
)
_STRTOF_WS = " \t\n\v\f\r"  # the C isspace set strtof skips before a token


def _strtof_py(s: str, pos: int):
    """Pure-Python strtof: (value, end_pos); end_pos == pos -> no conversion."""
    p, n = pos, len(s)
    while p < n and s[p] in _STRTOF_WS:
        p += 1
    m = _CFLOAT.match(s, p)
    if m is None:
        return 0.0, pos
    tok = m.group(0)
    if "(" in tok:  # nan(char-seq): float() rejects the payload; keep the sign as strtof does
        v = math.copysign(math.nan, -1.0 if tok[0] == "-" else 1.0)
    elif "x" in tok or "X" in tok:
        v = float.fromhex(tok)
    else:
        v = float(tok)
    return v, m.end()


def _floats(text: str) -> np.ndarray:
    return np.array([float(t) for t in text.split()], dtype=np.float32)


def _next_line(lines):
    try:
        return next(lines)
    except StopIteration:
        raise ValueError("truncated network file: expected more weight/bias rows") from None


def parse_network_text(text: str) -> List[RawLayer]:
    """Parse nnet1 text into affine layers (weights [out, in], bias [out]);
    a `<LinearTransform>` and the `<AffineTransform>` after it make one
    low-rank layer (bottleneck [k, in], weights [out, k])."""
    layers: List[RawLayer] = []
    lines = iter(text.splitlines())
    node_count = -1
    input_count = -1
    linear = False  # the component being read is a <LinearTransform>
    pending = None  # a <LinearTransform>'s weights, waiting for its <AffineTransform>
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith(("<AffineTransform>", "<LinearTransform>")):
            if pending is not None and line.startswith("<LinearTransform>"):
                raise ValueError("a <LinearTransform> must be followed by an <AffineTransform>")
            linear = line.startswith("<LinearTransform>")
            rest = line[line.index(">") + 1 :].split()
            node_count, input_count = int(rest[0]), int(rest[1])
            if pending is not None and input_count != pending.shape[0]:
                raise ValueError(f"<AffineTransform> takes {input_count} inputs after a "
                                 f"<LinearTransform> of {pending.shape[0]} outputs")
            continue
        if node_count == -1 or line.startswith("<") or line in ("[", "]"):
            continue
        # this line is the first weight row: node_count rows of weights,
        # then one bias row (the reference reads node_count + 1 rows); a
        # <LinearTransform> has no bias row
        weights = np.empty((node_count, input_count), dtype=np.float32)
        bias = np.empty(node_count, dtype=np.float32)
        row = line
        for i in range(node_count + (0 if linear else 1)):
            if i > 0:
                row = _next_line(lines)
            vals = _floats(row.replace("[", " ").replace("]", " "))
            if i < node_count:
                if vals.shape[0] != input_count:
                    raise ValueError(
                        f"weight row {i} has {vals.shape[0]} values, expected {input_count}"
                    )
                weights[i] = vals
            else:
                if vals.shape[0] != node_count:
                    raise ValueError(
                        f"bias row has {vals.shape[0]} values, expected {node_count}"
                    )
                bias = vals
        node_count = -1
        if linear:
            pending = weights
            continue
        layers.append(RawLayer(weights, bias, pending))
        pending = None
    if pending is not None:
        raise ValueError("a <LinearTransform> must be followed by an <AffineTransform>")
    return layers


def parse_transform_text(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a feature-transform file into (shift, scale) float32 vectors."""
    blocks = [m.group(1).strip() for m in _BRACKET_BLOCK.finditer(text.replace("\n", " "))]
    if len(blocks) == 3:  # a leading <Splice> block is dropped
        blocks = blocks[1:]
    if len(blocks) != 2:
        raise ValueError(f"expected 2 transform blocks (shift, scale), got {len(blocks)}")
    return _floats(blocks[0]), _floats(blocks[1])


def load_network_text(network_path, transform_path) -> RawNetwork:
    """Parse network + transform text files into a RawNetwork; the shift
    and scale lengths must equal the network's input dim."""
    with open(network_path) as f:
        layers = parse_network_text(f.read())
    with open(transform_path) as f:
        shift, scale = parse_transform_text(f.read())
    input_dim = layers[0].input_dim
    if shift.shape[0] != input_dim:
        raise ValueError(f"shift vector size {shift.shape[0]} != network input dim {input_dim}")
    if scale.shape[0] != input_dim:
        raise ValueError(f"scale vector size {scale.shape[0]} != network input dim {input_dim}")
    return RawNetwork(layers, shift, scale)


def _commit_row(dim: int, row_len: int, frames: int, utt_id: str) -> int:
    """The feature dim after a row of `row_len` values ends; ragged rows raise."""
    if dim == 0:
        return row_len
    if row_len != dim:
        raise ValueError(
            f"ragged rows in utterance {utt_id!r}: row {frames} has {row_len} values, "
            f"expected {dim}"
        )
    return dim


def parse_features_text(text: str) -> Dict[str, np.ndarray]:
    """Parse a Kaldi text feature file -> {utterance_id: [frames, dim]}.

    A single-pass tokenizer pairing each id with the block after it:
      * the utterance id is the first whitespace token before each `[`;
        further tokens between the id and `[` are ignored;
      * ' ', '\\t', '\\r' separate values; '\\n' ends a row; strtof itself
        also skips any C isspace (\\v, \\f, and a \\n they precede) before a
        token and takes inf, nan(char-seq) and hex tokens;
      * `]`, or the end of the text reached through whitespace, closes the
        block and ends a row in progress; the end of the text right after a
        token leaves that row unfinished and the file rejected;
      * ragged rows, a token that is not a number, or an empty block raise
        ValueError;
      * text after the last block (an id without a block) is ignored;
      * a file with no complete utterance raises ValueError.
    """
    result: Dict[str, np.ndarray] = {}
    n = len(text)
    token_at = None
    if _C_STRTOF is not None:
        try:
            data = text.encode("ascii")
        except UnicodeEncodeError:
            data = None  # offsets would diverge on non-ASCII bytes: use Python
        if data is not None:
            buf = ctypes.create_string_buffer(data)  # NUL-terminated
            base = ctypes.addressof(buf)

            def token_at(p):
                endp = ctypes.c_void_p()
                v = _C_STRTOF(base + p, ctypes.byref(endp))
                return v, (endp.value or base) - base

    if token_at is None:

        def token_at(p):
            return _strtof_py(text, p)

    pos = 0
    while True:
        lb = text.find("[", pos)
        if lb == -1:
            break  # a trailing id without a block is dropped
        head = text[pos:lb].split()
        utt_id = head[0] if head else ""
        vals: List[float] = []
        dim = frames = row_len = 0
        p = lb + 1
        while p < n:  # the end of text right after a token leaves the row unfinished
            while p < n and text[p] in " \t\r":
                p += 1
            if p < n and text[p] == "\n":
                if row_len:
                    dim = _commit_row(dim, row_len, frames, utt_id)
                    frames += 1
                    row_len = 0
                p += 1
                continue
            if p >= n or text[p] == "]":
                if row_len:
                    dim = _commit_row(dim, row_len, frames, utt_id)
                    frames += 1
                    row_len = 0
                if p < n:
                    p += 1  # past ']'
                break
            v, q = token_at(p)
            if q == p:
                # no conversion: garbage, a second '[', or whitespace running into ']'
                raise ValueError(
                    f"utterance {utt_id!r}: bad float at offset {p}: {text[p:p + 12]!r}"
                )
            vals.append(v)
            row_len += 1
            p = q
        if dim == 0 or frames == 0:
            raise ValueError(f"empty feature block for utterance {utt_id!r}")
        if len(vals) != frames * dim:
            raise ValueError(f"file truncated mid-row in utterance {utt_id!r}")
        result[utt_id] = np.array(vals, dtype=np.float32).reshape(frames, dim)
        pos = p
    if not result:
        raise ValueError("no complete utterance blocks found")
    return result


def load_features_text(path) -> Dict[str, np.ndarray]:
    """Read a Kaldi text feature file -> {utterance_id: [frames, dim]}."""
    with open(path) as f:
        return parse_features_text(f.read())


def write_features_text_kaldi(feats: Dict[str, np.ndarray], f) -> None:
    """Write {utterance_id: [frames, dim]} in the Kaldi text feature format
    this module parses (utt-id [ rows ]), to a path or a text file object."""

    def _emit(fh):
        for utt_id, mat in feats.items():
            fh.write(f"{utt_id}  [\n")
            rows = [" ".join(f"{v:.6f}" for v in row) for row in np.asarray(mat)]
            fh.write("\n".join("  " + r for r in rows))
            fh.write(" ]\n")

    if hasattr(f, "write"):
        _emit(f)
    else:
        with open(f, "w") as fh:
            _emit(fh)


def first_utterance(path) -> np.ndarray:
    """The first utterance's frames (the reference's BatchData.loadFromText)."""
    return next(iter(load_features_text(path).values()))
