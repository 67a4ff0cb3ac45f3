"""pbrt token stream → block-segment tree + typed property lookup.

Mirrors the reference's segment/property model
(reference src/scene_file_parser/mod.rs): a file is a list of
segments; a segment is either an Object (`Directive prop prop ...`) or a
Block (`XxxBegin [name] ... XxxEnd`). Properties are either bare values
(`LookAt 0 0 0 ...`) or typed values (`"float fov" [37.5]`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union

from curry_pbrt_tpu_torch.sceneio.lexer import Tok, tokenize_file

_TYPED_PREFIXES = {"string", "float", "spectrum", "texture", "integer", "rgb", "point", "color",
                   "normal", "bool", "blackbody"}


@dataclass
class Property:
    """Either a bare value run or a `"type name" values` pair."""

    type_name: str  # "" for bare values
    name: str  # "" for bare values
    values: List[Tok]  # flattened (arrays expanded)
    file: str = ""


@dataclass
class PropertySet:
    props: List[Property]

    def get_name(self) -> Optional[str]:
        """First bare string — e.g. `Camera "perspective"` → "perspective"."""
        if self.props and self.props[0].type_name == "" and self.props[0].values:
            v = self.props[0].values[0]
            if v.kind == "string":
                return v.value
        return None

    def find(self, name: str) -> Optional[Property]:
        for p in self.props:
            if p.type_name and p.name == name:
                return p
        return None

    def has(self, name: str) -> bool:
        return self.find(name) is not None

    # -- typed accessors -------------------------------------------------

    def get_floats(self, name: str) -> Optional[List[float]]:
        p = self.find(name)
        if p is None:
            return None
        return [float(t.value) for t in p.values]

    def get_float(self, name: str, default=None):
        v = self.get_floats(name)
        return default if v is None else float(v[0])

    def get_ints(self, name: str) -> Optional[List[int]]:
        p = self.find(name)
        if p is None:
            return None
        return [int(t.value) for t in p.values]

    def get_int(self, name: str, default=None):
        v = self.get_ints(name)
        return default if v is None else int(v[0])

    def get_string(self, name: str, default=None):
        p = self.find(name)
        if p is None:
            return default
        return p.values[0].value

    def get_path(self, name: str) -> Optional[Path]:
        """String property resolved relative to the file it appeared in
        (reference: BasicTypes::get_path, mod.rs:301-307)."""
        p = self.find(name)
        if p is None or not p.values or p.values[0].kind != "string":
            return None
        return Path(p.values[0].file).parent / p.values[0].value

    def get_spectrum_property(self, name: str):
        """Returns (kind, payload) where kind ∈ {'rgb','spectrum','texture',
        'float'} — the scene compiler converts to RGB / texture refs."""
        p = self.find(name)
        if p is None:
            return None
        vals = [t.value for t in p.values]
        return (p.type_name, vals)

    def bare_floats(self) -> List[float]:
        """All bare (untyped) numeric values in order — used by transform
        directives like `LookAt x y z ...`."""
        out = []
        for p in self.props:
            if p.type_name == "":
                for t in p.values:
                    if t.kind in ("int", "float"):
                        out.append(float(t.value))
        return out

    def bare_strings(self) -> List[str]:
        out = []
        for p in self.props:
            if p.type_name == "":
                for t in p.values:
                    if t.kind == "string":
                        out.append(t.value)
        return out


@dataclass
class BlockSegment:
    """Object(directive) or Block(nested)."""

    object_type: str = ""  # for objects
    properties: Optional[PropertySet] = None
    block_type: str = ""  # for blocks
    block_name: Optional[str] = None
    children: List["BlockSegment"] = field(default_factory=list)

    @property
    def is_block(self) -> bool:
        return bool(self.block_type)


def _flatten(tok: Tok) -> List[Tok]:
    if tok.kind == "array":
        out: List[Tok] = []
        for t in tok.value:
            out.extend(_flatten(t))
        return out
    return [tok]


def _parse_property(toks: List[Tok], i: int) -> Tuple[Property, int]:
    t = toks[i]
    if t.kind == "string":
        words = str(t.value).split()
        if len(words) == 2 and words[0] in _TYPED_PREFIXES:
            type_name, name = words
            i += 1
            vals = _flatten(toks[i])
            # tag value tokens with the declaring file for path resolution
            for v in vals:
                if not v.file:
                    v.file = t.file
            return Property(type_name, name, vals, t.file), i + 1
        return Property("", "", [t], t.file), i + 1
    vals = _flatten(t)
    return Property("", "", vals, t.file), i + 1


def segments_from_tokens(toks: List[Tok]) -> List[BlockSegment]:
    segments: List[BlockSegment] = []
    i = 0

    def parse_segment(i: int) -> Tuple[BlockSegment, int]:
        t = toks[i]
        if t.kind == "type":
            i += 1
            props: List[Property] = []
            while i < len(toks) and toks[i].kind not in ("type", "block_begin", "block_end"):
                p, i = _parse_property(toks, i)
                props.append(p)
            return BlockSegment(object_type=t.value, properties=PropertySet(props)), i
        if t.kind == "block_begin":
            block_type = t.value
            i += 1
            name = None
            if i < len(toks) and toks[i].kind == "string":
                name = toks[i].value
                i += 1
            children = []
            while i < len(toks):
                if toks[i].kind == "block_end":
                    if toks[i].value != block_type:
                        raise ValueError(
                            f"{toks[i].file}:{toks[i].line}: unpaired block end "
                            f"{toks[i].value!r} (expected {block_type!r})"
                        )
                    i += 1
                    break
                child, i = parse_segment(i)
                children.append(child)
            return BlockSegment(block_type=block_type, block_name=name, children=children), i
        raise ValueError(f"{t.file}:{t.line}: unexpected token {t.kind} {t.value!r}")

    while i < len(toks):
        seg, i = parse_segment(i)
        segments.append(seg)
    return segments


def read_scene(path) -> List[BlockSegment]:
    return segments_from_tokens(tokenize_file(path))


def find_segment(segments: List[BlockSegment], object_type: str) -> Optional[BlockSegment]:
    for s in segments:
        if not s.is_block and s.object_type == object_type:
            return s
    return None


def find_block(segments: List[BlockSegment], block_type: str) -> Optional[BlockSegment]:
    for s in segments:
        if s.is_block and s.block_type == block_type:
            return s
    return None
