"""Toolbox .pmap consumption: the generated-TLA -> PlusCal source map (a
copy of jaxtlc/frontend/pmap.py, which imports no jax; the port keeps its
own).

A Toolbox's `KubeAPI.tla.pmap` is a Java-serialized
``pcal.TLAtoPCalMapping``: for every line of the PlusCal TRANSLATION region of the .tla file it stores mapping objects (source
tokens and paren pairs) pointing back into the PlusCal algorithm text.
The Toolbox uses it to jump from TLC errors (reported against generated
TLA lines) to the PlusCal the user wrote; TLC itself never reads it.

This module implements the consumer: a dependency-free reader for the
Java Object Serialization Stream Protocol subset these files use
(TC_OBJECT/TC_CLASSDESC/TC_ARRAY/TC_STRING/TC_REFERENCE/TC_NULL, plain
SC_SERIALIZABLE classes), plus the location query the trace renderer
needs: TLA line -> PlusCal (line, column) of the nearest mapped token.

Object model (pcal/TLAtoPCalMapping.java, pcal/MappingObject.java):
  * ``tlaStartLine``: first TLA line (1-based) of the translation region;
    ``mapping[i]`` describes TLA line ``tlaStartLine + i``.
  * ``algLine``/``algColumn``: 0-based position of the ``--algorithm``
    token; PCalLocation lines are relative to it.
  * MappingObject subclasses: SourceToken (begin/end column + PlusCal
    location), Begin/EndTLAToken (column only), Left/RightParen
    (PlusCal location).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

MAGIC = 0xACED

TC_NULL = 0x70
TC_REFERENCE = 0x71
TC_CLASSDESC = 0x72
TC_OBJECT = 0x73
TC_STRING = 0x74
TC_ARRAY = 0x75
TC_ENDBLOCKDATA = 0x78
BASE_HANDLE = 0x7E0000

_PRIM_SIZES = {"B": 1, "C": 2, "D": 8, "F": 4, "I": 4, "J": 8, "S": 2,
               "Z": 1}
_PRIM_FMT = {"B": ">b", "C": ">H", "D": ">d", "F": ">f", "I": ">i",
             "J": ">q", "S": ">h", "Z": ">?"}


class PmapError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.handles: List[object] = []

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise PmapError("truncated stream")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u1(self) -> int:
        return self.take(1)[0]

    def u2(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def i4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def utf(self) -> str:
        n = self.u2()
        return self.take(n).decode("utf-8")

    def new_handle(self, obj) -> int:
        self.handles.append(obj)
        return BASE_HANDLE + len(self.handles) - 1

    def ref(self):
        h = self.i4() - BASE_HANDLE
        if not 0 <= h < len(self.handles):
            raise PmapError(f"bad handle {h}")
        return self.handles[h]

    # -- grammar ----------------------------------------------------------

    def stream(self):
        if self.u2() != MAGIC or self.u2() != 5:
            raise PmapError("not a Java serialization stream")
        return self.content()

    def content(self):
        tc = self.u1()
        if tc == TC_OBJECT:
            return self.object()
        if tc == TC_ARRAY:
            return self.array()
        if tc == TC_STRING:
            s = self.utf()
            self.new_handle(s)
            return s
        if tc == TC_REFERENCE:
            return self.ref()
        if tc == TC_NULL:
            return None
        raise PmapError(f"unsupported type code 0x{tc:02x}")

    def class_desc(self) -> Dict:
        tc = self.u1()
        if tc == TC_NULL:
            return None
        if tc == TC_REFERENCE:
            return self.ref()
        if tc != TC_CLASSDESC:
            raise PmapError(f"expected classDesc, got 0x{tc:02x}")
        name = self.utf()
        self.take(8)  # serialVersionUID
        desc: Dict = {"name": name}
        self.new_handle(desc)
        flags = self.u1()
        if flags & ~0x02:
            raise PmapError(
                f"class {name}: only plain SC_SERIALIZABLE supported "
                f"(flags 0x{flags:02x})"
            )
        nfields = self.u2()
        fields = []
        for _ in range(nfields):
            t = chr(self.u1())
            fname = self.utf()
            if t in ("L", "["):
                self.content()  # the field's type-name string
            fields.append((t, fname))
        desc["fields"] = fields
        if self.u1() != TC_ENDBLOCKDATA:
            raise PmapError("expected end of class annotation")
        desc["super"] = self.class_desc()
        return desc

    def object(self) -> Dict:
        desc = self.class_desc()
        obj: Dict = {"__class__": desc["name"]}
        self.new_handle(obj)
        # field values: superclass first
        chain = []
        d = desc
        while d is not None:
            chain.append(d)
            d = d["super"]
        for d in reversed(chain):
            for t, fname in d["fields"]:
                if t in _PRIM_SIZES:
                    obj[fname] = struct.unpack(
                        _PRIM_FMT[t], self.take(_PRIM_SIZES[t])
                    )[0]
                else:
                    obj[fname] = self.content()
        return obj

    def array(self) -> List:
        desc = self.class_desc()
        arr: List = []
        self.new_handle(arr)
        n = self.i4()
        comp = desc["name"][1]  # "[Lpcal..." -> component type code
        for _ in range(n):
            if comp in _PRIM_SIZES:
                arr.append(struct.unpack(
                    _PRIM_FMT[comp], self.take(_PRIM_SIZES[comp]))[0])
            else:
                arr.append(self.content())
        return arr


class TLAtoPCalMapping:
    """Parsed mapping + the TLA-line -> PlusCal-location query."""

    def __init__(self, alg_line: int, alg_column: int, tla_start_line: int,
                 mapping: List[List[Dict]]):
        self.alg_line = alg_line
        self.alg_column = alg_column
        self.tla_start_line = tla_start_line
        self.mapping = mapping

    @property
    def n_lines(self) -> int:
        return len(self.mapping)

    def pcal_location(self, tla_line: int) -> Optional[Tuple[int, int]]:
        """PlusCal (1-based file line, 0-based column) of the first mapped
        token on the given 1-based TLA line; scans earlier translation
        lines if that line carries only structural tokens."""
        row0 = tla_line - self.tla_start_line
        if not 0 <= row0 < len(self.mapping):
            return None
        for row in range(row0, -1, -1):
            for obj in self.mapping[row]:
                # SourceToken carries an origin Region; parens carry a
                # bare PCalLocation
                loc = obj.get("location")
                origin = obj.get("origin")
                if isinstance(origin, dict):
                    loc = origin.get("begin")
                if isinstance(loc, dict) and "line" in loc:
                    # PCalLocation.line is the 0-based absolute file line
                    # (verified against the committed artifact: the CStart
                    # action row points at the `either` statement,
                    # KubeAPI.tla:167)
                    return (loc["line"] + 1, loc["column"])
        return None


def parse_pmap_bytes(data: bytes) -> TLAtoPCalMapping:
    try:
        root = _Reader(data).stream()
    except PmapError:
        raise
    except Exception as e:  # noqa: BLE001 - parser boundary: corrupt
        # bytes can surface as UnicodeDecodeError / struct.error /
        # RecursionError etc.; callers guard on PmapError only
        raise PmapError(f"corrupt pmap stream: {type(e).__name__}: {e}")
    if not isinstance(root, dict) or (
        root.get("__class__") != "pcal.TLAtoPCalMapping"
    ):
        raise PmapError("unexpected root object")
    try:
        return TLAtoPCalMapping(
            alg_line=root["algLine"],
            alg_column=root["algColumn"],
            tla_start_line=root["tlaStartLine"],
            mapping=root["mapping"],
        )
    except KeyError as e:
        raise PmapError(f"pmap root missing field {e}")


def parse_pmap_file(path: str) -> TLAtoPCalMapping:
    with open(path, "rb") as f:
        return parse_pmap_bytes(f.read())
