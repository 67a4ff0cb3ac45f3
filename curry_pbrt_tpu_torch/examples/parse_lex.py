"""Dump the raw token stream of a scene file (reference:
examples/parse_lex.rs).

    python -m curry_pbrt_tpu_torch.examples.parse_lex scene.pbrt
"""

import sys

from curry_pbrt_tpu_torch.sceneio.lexer import tokenize_file


def main(argv=None):
    path = (sys.argv[1:] if argv is None else argv)[0]
    for tok in tokenize_file(path):
        print(tok.kind, repr(tok.value) if tok.kind != "array" else f"[{len(tok.value)} tokens]")


if __name__ == "__main__":
    main()
