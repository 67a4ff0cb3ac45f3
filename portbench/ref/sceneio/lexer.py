"""pbrt scene-file lexer.

Produces the same token stream semantics as the reference lexer
(reference src/scene_file_parser/lex.rs): strings, ints/floats,
`[...]` arrays, `#` line comments, `XxxBegin`/`XxxEnd` block markers,
capitalized directive words, and `Include "file"` splicing (resolved
relative to the including file).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Union


@dataclass
class Tok:
    kind: str  # 'type' | 'block_begin' | 'block_end' | 'string' | 'int' | 'float' | 'array'
    value: Union[str, int, float, List["Tok"]]
    file: str = ""
    line: int = 0


class LexError(ValueError):
    pass


_WORD_RE = re.compile(r"[^\s\]]+")


def tokenize_string(s: str, file: str = "<string>") -> List[Tok]:
    toks: List[Tok] = []
    array_stack: List[int] = []
    line = 1
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#":
            j = s.find("\n", i)
            i = n if j < 0 else j
        elif c == '"':
            j = s.find('"', i + 1)
            if j < 0:
                raise LexError(f"{file}:{line}: unpaired '\"'")
            content = s[i + 1 : j]
            if toks and toks[-1].kind == "type" and toks[-1].value == "Include":
                toks.pop()
                inc = Path(file).parent / content
                toks.extend(tokenize_file(inc))
            else:
                toks.append(Tok("string", content, file, line))
            i = j + 1
        elif c == "[":
            array_stack.append(len(toks))
            i += 1
        elif c == "]":
            if not array_stack:
                raise LexError(f"{file}:{line}: unpaired ']'")
            start = array_stack.pop()
            inner = toks[start:]
            del toks[start:]
            toks.append(Tok("array", inner, file, line))
            i += 1
        else:
            m = _WORD_RE.match(s, i)
            if not m:
                raise LexError(f"{file}:{line}: cannot lex {s[i:i+20]!r}")
            word = m.group(0)
            i = m.end()
            if word[0].isupper():
                if word.endswith("Begin"):
                    toks.append(Tok("block_begin", word[:-5], file, line))
                elif word.endswith("End"):
                    toks.append(Tok("block_end", word[:-3], file, line))
                else:
                    toks.append(Tok("type", word, file, line))
            else:
                try:
                    toks.append(Tok("int", int(word), file, line))
                except ValueError:
                    try:
                        toks.append(Tok("float", float(word), file, line))
                    except ValueError:
                        raise LexError(f"{file}:{line}: cannot parse number {word!r}")
    if array_stack:
        raise LexError(f"{file}: unclosed '['")
    return toks


def tokenize_file(path) -> List[Tok]:
    path = Path(path)
    return tokenize_string(path.read_text(), str(path))
