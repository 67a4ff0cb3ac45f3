from curry_pbrt_tpu_torch.sceneio.lexer import tokenize_file, tokenize_string  # noqa: F401
from curry_pbrt_tpu_torch.sceneio.parser import (  # noqa: F401
    BlockSegment,
    PropertySet,
    read_scene,
    segments_from_tokens,
)
