"""Generate, or check, the rendering tables the port takes from `cv2`.

The port draws label text and heatmaps without `cv2` (the card's
machine has none), so two tables are rendered here once, with the
sandbox's `cv2`, and committed into the package:

  * `hrfuser_tpu_torch/utils/glyphs.py`: one coverage mask and one
    advance for each printable ASCII character, at the arguments of the
    JAX `draw_detections` label (`FONT_HERSHEY_SIMPLEX`, scale 0.45,
    thickness 1, `LINE_AA`). Each character is drawn alone in white on
    black; its mask is the drawn pixels' bounding box, placed by its
    offset from the text origin; its advance is `getTextSize` of the
    character repeated, which `cv2` 5.0 keeps a whole number of pixels.
  * `hrfuser_tpu_torch/utils/visualization.py:TURBO`: `COLORMAP_TURBO`'s
    256 BGR entries, `cv2.applyColorMap(np.arange(256, dtype=np.uint8)
    [:, None], cv2.COLORMAP_TURBO)`.

    python -m tests.oracles.make_render_tables           # rewrite glyphs.py
    python -m tests.oracles.make_render_tables --check   # compare both

This is the one file under `tests/oracles/` that imports `cv2`; it runs
in the sandbox only, never on the card.
"""

import argparse
import base64
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
GLYPHS = ROOT / 'hrfuser_tpu_torch' / 'utils' / 'glyphs.py'
FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1
FIRST, LAST = 32, 126
ORIGIN = (32, 48)                      # (x, y) of the text origin
CANVAS = (96, 96)


def glyph(code: int):
    """(advance, dx, dy, mask) of one character: `mask` uint8 [h, w]
    holds the drawn coverage, its top-left pixel at (x + dx, y + dy) for
    a text origin (x, y)."""
    ch = chr(code)
    width = cv2.getTextSize(ch * 100, FONT, SCALE, THICKNESS)[0][0]
    advance, rest = divmod(width - 1, 100)
    if rest:
        raise ValueError(f'{ch!r}: advance {width - 1} / 100 px is not '
                         f'a whole number of pixels')
    img = np.zeros(CANVAS, np.uint8)
    cv2.putText(img, ch, ORIGIN, FONT, SCALE, 255, THICKNESS, cv2.LINE_AA)
    ys, xs = np.nonzero(img)
    if not len(ys):
        return advance, 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    if min(y0, x0) == 0 or y1 == CANVAS[0] or x1 == CANVAS[1]:
        raise ValueError(f'{ch!r} reaches the edge of the canvas')
    return (advance, int(x0 - ORIGIN[0]), int(y0 - ORIGIN[1]),
            img[y0:y1, x0:x1].copy())


def table_bytes() -> bytes:
    """Every character's record, in code order: advance, dx, dy (int8),
    h, w (uint8), then h * w coverage bytes."""
    out = bytearray()
    for code in range(FIRST, LAST + 1):
        advance, dx, dy, mask = glyph(code)
        out += np.array([advance, dx, dy, *mask.shape], np.int8).tobytes()
        out += mask.tobytes()
    return bytes(out)


def encoded() -> str:
    text = base64.b64encode(zlib.compress(table_bytes(), 9)).decode()
    return '\n'.join(text[i:i + 72] for i in range(0, len(text), 72))


def turbo() -> np.ndarray:
    """`COLORMAP_TURBO` as [256, 3] uint8 BGR."""
    return cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             cv2.COLORMAP_TURBO)[:, 0]


def module_text() -> str:
    return f'''"""Label glyphs for `utils/visualization.py`, rendered from `cv2`.

`cv2.putText`'s Hershey font is compiled into `cv2` and is not in the
repository. This table holds what it draws for each printable ASCII
character at the JAX label's arguments (`FONT_HERSHEY_SIMPLEX`, scale
{SCALE}, thickness {THICKNESS}, `LINE_AA`): the coverage mask, drawn alone
in white on black, its offset from the text origin and the advance to
the next character. Generated by `tests/oracles/make_render_tables.py`
(do not edit; rerun it with `cv2` at hand).
"""

import base64
import zlib
from functools import lru_cache
from typing import Tuple

import numpy as np

FIRST, LAST = {FIRST}, {LAST}
_DATA = """
{encoded()}
"""


@lru_cache(maxsize=None)
def table() -> Tuple[Tuple[int, int, int, np.ndarray], ...]:
    """(advance, dx, dy, mask uint8 [h, w]) of codes FIRST..LAST: a
    character drawn at pen position (x, y) covers rows y + dy .. and
    columns x + dx .. with `mask`, and moves the pen by `advance`."""
    raw = np.frombuffer(zlib.decompress(base64.b64decode(_DATA)), np.uint8)
    out, pos = [], 0
    for _ in range(FIRST, LAST + 1):
        advance, dx, dy, h, w = raw[pos:pos + 5].view(np.int8).tolist()
        h, w = h & 255, w & 255
        pos += 5
        out.append((advance, dx, dy, raw[pos:pos + h * w].reshape(h, w)))
        pos += h * w
    return tuple(out)


def index(ch: str) -> int:
    """`ch`'s row of `table()`; a character outside printable ASCII
    draws as '?', as `cv2.putText` draws it."""
    code = ord(ch)
    return (code if FIRST <= code <= LAST else ord('?')) - FIRST


def glyph(ch: str) -> Tuple[int, int, int, np.ndarray]:
    """One character's (advance, dx, dy, mask)."""
    return table()[index(ch)]
'''


def check() -> list:
    """What differs between the committed tables and `cv2`'s."""
    sys.path.insert(0, str(ROOT))
    from hrfuser_tpu_torch.utils import glyphs, visualization
    bad = []
    for code in range(FIRST, LAST + 1):
        want = glyph(code)
        got = glyphs.glyph(chr(code))
        if want[:3] != got[:3] or not np.array_equal(want[3], got[3]):
            bad.append(f'glyph {chr(code)!r}')
    if not np.array_equal(np.asarray(visualization.TURBO, np.uint8),
                          turbo()):
        bad.append('TURBO')
    return bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--check', action='store_true')
    args = p.parse_args(argv)
    if args.check:
        bad = check()
        print('tables equal cv2' if not bad else f'differ: {bad}')
        return 1 if bad else 0
    GLYPHS.write_text(module_text())
    print(f'wrote {GLYPHS}')
    text = turbo().tobytes().hex()
    print('TURBO (BGR bytes, hex):')
    print('\n'.join(text[i:i + 64] for i in range(0, len(text), 64)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
