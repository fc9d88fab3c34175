"""libtiff's RGBA reader (`tif_getimage.c`, `TIFFRGBAImage`) as `cv2`
5.0 uses it, in numpy: every 'color' and 'grayscale' read of a TIFF, and
its 'unchanged' read of 1- to 8-bit samples, go through it. Each rule
below was found by testing `cv2` (tests/test_torch_tiff.py):

  * MinIsBlack / MinIsWhite: 1-bit samples 0 / 255 (white first for
    MinIsWhite); 8-bit as they are, `255 - v` for MinIsWhite; 16-bit
    their high byte (`v >> 8`, inverted likewise); the first sample a
    pixel. For an edge tile narrower than its tile, libtiff steps over
    the tile's unused columns as if each were one byte, so with more than
    one byte a pixel the rows after the first read from shifted offsets
    of the decoded tile (`_grey`).
  * Palette (1-, 4-, 8-bit indices): the colour map's entries, taken as
    16-bit (high byte) if any of them is 256 or more, else as they are.
  * RGB (and JPEG's YCbCr, which libjpeg makes RGB): 8-bit as they are,
    16-bit as `(v + 128) // 257`; a fourth sample is alpha, associated
    (ExtraSamples 0 or 1, or no ExtraSamples tag) or unassociated (2),
    whose colours are premultiplied `(v * a + 127) // 255`.
  * Separated (CMYK, 8-bit, 4 samples): `(255 - k) * (255 - ink) // 255`,
    alpha 255.
  * Tiles are read one at a time and a mirroring orientation (2, 3, 6,
    7) mirrors each tile's columns within the tile (`orient_rgba`).
Then `cv2`: BGR for 'color', `cvt.bgr_to_grey` for 'grayscale', and for
'unchanged' one channel (grey images and 1-bit palettes, through
`cvt.bgr_to_grey`), BGRA (4 samples), or BGR, int8 for signed samples.
The raw route (`raw_image`) is `cv2`'s 'unchanged' read of 16-, 32- and
64-bit samples, which bypasses this reader.
"""

from __future__ import annotations

import numpy as np

from hrfuser_tpu_torch.data import cvt


def _refuse(lay, why: str) -> ValueError:
    return ValueError(f'TIFF tag 262 (PhotometricInterpretation) = '
                      f'{lay.photometric} with {lay.spp} samples of '
                      f'{lay.bits} bits: {why}')


def raw_route(lay, flag: str) -> bool:
    """True where `cv2` reads the samples as stored ('unchanged' of 16-,
    32-, 64-bit grey or RGB samples, 1, 3 or 4 a pixel); False where it
    takes the RGBA reader. Raises where `cv2` returns None or reads no
    defined answer."""
    if lay.bits <= 8 or lay.photometric > 2 or lay.spp == 2:
        if lay.bits > 16:
            raise _refuse(lay, 'cv2 returns None (the RGBA reader takes '
                          'samples of up to 16 bits)')
        return False
    if flag != 'unchanged':
        if lay.bits > 16:
            raise ValueError(f'a TIFF of {lay.bits}-bit samples read {flag}: '
                             f'cv2 returns None (the RGBA reader takes '
                             f'samples of up to 16 bits)')
        return False
    if lay.planar == 2:
        raise ValueError(f'a planar TIFF of {lay.spp} {lay.bits}-bit '
                         f'samples read unchanged: cv2 reads past the first '
                         f'plane, no answer is defined')
    if lay.photometric < 2 and lay.spp > 1 and (lay.bits > 16
                                                 or lay.sample_format != 1):
        raise _refuse(lay, 'a grey image of several signed or wide samples')
    return True


def raw_image(img: np.ndarray, lay) -> np.ndarray:
    """`cv2`'s 'unchanged' read of [H, W, spp] samples as stored: one
    channel, BGR or BGRA; several 16-bit grey samples through the 14-bit
    grey of the first three (red first)."""
    if lay.spp == 1:
        return img[..., 0]
    if lay.photometric < 2:
        return cvt.bgr_to_grey(img[..., :3], rgb=True)
    return img[..., [2, 1, 0, 3][:lay.spp]]


def check_rgba(lay) -> None:
    """Raise where libtiff's RGBA reader or `cv2` refuse the layout, or
    where the port does not follow them."""
    p, bits, spp = lay.photometric, lay.bits, lay.spp
    if p in (0, 1):
        if bits == 4:
            raise _refuse(lay, 'cv2 reads 4-bit samples as a palette only')
        if bits == 1 and spp > 1:
            raise _refuse(lay, 'libtiff reads 1-bit grey of one sample only')
        if lay.planar == 2:
            raise _refuse(lay, 'grey planes are not read')
    elif p in (2, 6):
        if bits not in (8, 16) or spp < 3:
            raise _refuse(lay, 'RGB is read from 3 or 4 samples of 8 or 16 '
                          'bits')
    elif p == 3:
        if spp != 1 or bits == 16:
            raise _refuse(lay, 'a palette is read from one 1-, 4- or 8-bit '
                          'index')
    elif p == 5:
        if spp != 4 or bits != 8:
            raise _refuse(lay, 'CMYK is read from 4 samples of 8 bits')


def _unsigned(a: np.ndarray) -> np.ndarray:
    """Samples as their unsigned bits, int64."""
    if a.dtype.kind == 'i':
        a = a.view(f'u{a.dtype.itemsize}')
    return a.astype(np.int64)


def _grey(full: np.ndarray, lay) -> np.ndarray:
    """The byte libtiff takes for each grey pixel (8-bit: the first
    sample; 16-bit: its high byte), int64 [H, W], edge tiles shifted as
    libtiff's grey tile routines read them."""
    h, w = lay.height, lay.width
    size = lay.bits // 8
    out = _unsigned(full[:h, :w, 0]) >> (8 * (size - 1))
    step = size * lay.spp
    if not lay.tile or step == 1 or w % lay.tile[1] == 0:
        return out
    th, tw = lay.tile
    x0 = w - w % tw
    valid = w - x0
    rows = np.arange(th)[:, None] * (step * valid + tw - valid)
    at = rows + step * np.arange(valid)[None] + size - 1
    for y0 in range(0, h, th):
        tile = np.ascontiguousarray(full[y0:y0 + th, x0:x0 + tw].astype(
            full.dtype.newbyteorder('<'))).view(np.uint8).reshape(-1)
        n = min(th, h - y0)
        out[y0:y0 + n, x0:] = tile[at[:n]]
    return out


def rgba(full: np.ndarray, lay) -> np.ndarray:
    """The RGBA reader's pixels (uint8 [H, W, 4], R, G, B, A) in the
    file's row order, before orientation, from all samples `full` ([H',
    W', spp], tiles whole)."""
    h, w = lay.height, lay.width
    s = full[:h, :w]
    alpha = np.full((h, w), 255, np.int64)
    p = lay.photometric
    if p in (0, 1):
        if lay.bits == 1:
            g = s[..., 0].astype(np.int64) * 255
        else:
            g = _grey(full, lay)
        if p == 0:
            g = 255 - g
        rgb = [g, g, g]
    elif p == 3:
        cmap = lay.colormap
        if (cmap >= 256).any():
            cmap = cmap >> 8
        rgb = list(np.moveaxis(cmap[s[..., 0]], -1, 0))
    elif p == 5:
        c = _unsigned(s)
        k = 255 - c[..., 3]
        rgb = [k * (255 - c[..., i]) // 255 for i in range(3)]
    else:
        c = _unsigned(s)
        if lay.bits == 16:
            c = (c + 128) // 257
        rgb = [c[..., i] for i in range(3)]
        if lay.spp >= 4 and lay.alpha:
            alpha = c[..., 3]
            if lay.alpha == 2:
                rgb = [(v * alpha + 127) // 255 for v in rgb]
    return np.stack(rgb + [alpha], -1).astype(np.uint8)


def orient(img: np.ndarray, o: int) -> np.ndarray:
    """The TIFF / EXIF orientation `o` applied: the image as displayed
    (5-8 transposed)."""
    if o >= 5:
        img = np.swapaxes(img, 0, 1)
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return img


def orient_rgba(img: np.ndarray, lay) -> np.ndarray:
    """`orient` as `cv2` reads through the RGBA reader: libtiff mirrors a
    tiled image one tile at a time, so each tile's columns are mirrored
    in place first."""
    if lay.tile and lay.orientation in (2, 3, 6, 7):
        tw = lay.tile[1]
        mirrored = img.copy()
        for x in range(0, lay.width, tw):
            mirrored[:, x:x + tw] = img[:, x:x + tw][:, ::-1]
        img = mirrored[:, ::-1]
    return orient(img, lay.orientation)


def rgba_read(full: np.ndarray, lay, flag: str) -> np.ndarray:
    """`cv2`'s read through the RGBA reader in mode `flag`."""
    px = orient_rgba(rgba(full, lay), lay)
    bgr = px[..., 2::-1]
    if flag == 'color':
        return np.ascontiguousarray(bgr)
    if flag == 'grayscale' or lay.photometric in (0, 1) or (
            lay.photometric == 3 and lay.bits == 1):
        out = cvt.bgr_to_grey(bgr)
    elif lay.spp == 4:
        out = np.ascontiguousarray(px[..., [2, 1, 0, 3]])
    else:
        out = np.ascontiguousarray(bgr)
    return out.view(np.int8) if (flag == 'unchanged'
                                 and lay.sample_format == 2) else out
