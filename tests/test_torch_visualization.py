"""The port's drawing and heatmaps (`utils/visualization.py`) against the
JAX package's `hrfuser_tpu/utils/visualization.py` (`cv2`), on the CPU.

Boxes, `denormalize_image` and `sensor_image_to_heatmap` are held
bit-equal. Label text is held bit-equal outside each label's box: the
`cv2.getTextSize` box grown by 2 pixels on every side (`cv2` draws a
pixel left of the box for 'j' and anti-aliases one pixel around a
stroke). Inside the boxes the test states the largest difference per
channel and the share of differing pixels; on these cases both are 0,
because `cv2` 5.0 advances the pen by whole pixels and the glyph table
holds exactly what it draws for each character.
"""

import zlib

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.utils import visualization as J
from hrfuser_tpu_torch.utils import glyphs
from hrfuser_tpu_torch.utils import visualization as P

NAMES = [f'class_{k}' for k in range(14)] + ['pedestrian', 'jay']


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(kind, rng, hw):
    """[N, 4] float32 boxes of one kind of case."""
    h, w = hw
    if kind == 'inside':
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (6, 2))
        return np.c_[xy, xy + rng.uniform(4, 30, (6, 2))].astype(np.float32)
    if kind == 'outside':          # partly or wholly outside the image
        return np.array([[-20, -15, 30, 25], [w - 10, h - 8, w + 40, h + 9],
                         [-50, 5, -3, 30], [10, h + 2, 40, h + 30],
                         [-1, -1, w, h], [w + 1, -5, w + 9, 12]],
                        np.float32)
    if kind == 'degenerate':       # x1 == x2, y1 > y2, points, negatives
        return np.array([[20, 10, 20, 40], [15, 40, 60, 12], [33, 33, 33, 33],
                         [-4, -7, -4, -7], [50, 20, 10, 20], [0, 0, 0, 0]],
                        np.float32)
    if kind == 'half':             # halves round to even
        return np.array([[10.5, 11.5, 40.5, 41.5], [2.5, 3.5, 20.49, 9.51],
                         [-0.5, 0.5, 1.5, 2.5], [12.5, 30.5, 13.5, 31.5],
                         [7.5, 7.5, 7.5, 7.5], [55.5, 44.5, 70.5, 60.5]],
                        np.float32)
    raise ValueError(kind)


def _text_mask(img_hw, boxes, labels, scores, names, thr):
    """Where JAX's labels may draw: each label's getTextSize box, grown
    by 2 px."""
    h, w = img_hw
    mask = np.zeros((h, w), bool)
    for i, box in enumerate(boxes):
        score = None if scores is None else float(scores[i])
        if score is not None and score < thr:
            continue
        cls = 0 if labels is None else int(labels[i])
        text = str(names[cls]) if names is not None and labels is not None \
            else ''
        if score is not None:
            text = f'{text} {score:.2f}'.strip()
        if not text:
            continue
        x, y = int(round(float(box[0]))), max(int(round(float(box[1]))) - 4,
                                              10)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         0.45, 1)
        mask[max(y - th - 2, 0):max(y + base + 2, 0),
             max(x - 2, 0):max(x + tw + 2, 0)] = True
    return mask


@pytest.mark.parametrize('kind', ['inside', 'outside', 'degenerate', 'half'])
@pytest.mark.parametrize('extras', ['none', 'labels', 'scores', 'all'])
def test_draw_detections_matches_jax(kind, extras):
    rng = np.random.default_rng(zlib.crc32(f'{kind}/{extras}'.encode()))
    hw = (64, 96)
    img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    boxes = _boxes(kind, rng, hw)
    n = len(boxes)
    labels = rng.integers(0, 16, n)          # ids >= 10 wrap the palette
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[0] = 0.05                         # below the threshold
    kw = dict(none={}, labels=dict(labels=labels),
              scores=dict(scores=scores, score_thr=0.3),
              all=dict(labels=labels, scores=scores, class_names=NAMES,
                       score_thr=0.3))[extras]
    want = J.draw_detections(img, boxes, **kw)
    got = P.draw_detections(img, boxes, device='cpu', **kw)
    assert got.dtype == torch.uint8 and got.device.type == 'cpu'
    got = got.numpy()
    text = _text_mask(hw, boxes, kw.get('labels'), kw.get('scores'),
                      kw.get('class_names'), kw.get('score_thr', 0.0))
    np.testing.assert_array_equal(got[~text], want[~text])
    diff = np.abs(got.astype(int) - want)[text]
    worst = diff.max(0) if diff.size else np.zeros(3, int)
    share = float((diff > 0).any(-1).mean()) if diff.size else 0.0
    print(f'{kind}/{extras}: inside the text boxes max |diff| per channel '
          f'{worst.tolist()}, {share:.4f} of their pixels differ')
    assert worst.tolist() == [0, 0, 0] and share == 0.0
    assert not np.array_equal(want, img) or extras == 'scores'


def test_rectangle_matches_cv2_on_random_boxes():
    """`rectangle_` against `cv2.rectangle(..., thickness=2)` on 800
    random images with 1-3 boxes each, a fifth of them with x1 == x2 or
    y1 == y2."""
    rng = np.random.default_rng(2)
    for _ in range(800):
        h, w = rng.integers(1, 40, 2)
        want = np.zeros((h, w, 3), np.uint8)
        got = torch.zeros((h, w, 3), dtype=torch.uint8)
        for _ in range(rng.integers(1, 4)):
            x1, x2 = (int(v) for v in rng.integers(-10, w + 10, 2))
            y1, y2 = (int(v) for v in rng.integers(-10, h + 10, 2))
            x2 = x1 if rng.random() < 0.2 else x2
            y2 = y1 if rng.random() < 0.2 else y2
            col = [int(v) for v in rng.integers(1, 256, 3)]
            cv2.rectangle(want, (x1, y1), (x2, y2), col, 2)
            P.rectangle_(got, (x1, y1), (x2, y2),
                         torch.tensor(col, dtype=torch.uint8))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match='only 2'):
        P.rectangle_(got, (0, 0), (1, 1), torch.tensor([1, 2, 3]), 1)


def test_labels_match_cv2_puttext():
    """Every printable character, in strings, on random backgrounds and
    colours, near the edges too: `put_text_` equals `cv2.putText`."""
    rng = np.random.default_rng(0)
    chars = ''.join(chr(c) for c in range(glyphs.FIRST, glyphs.LAST + 1))
    for i in range(60):
        text = chars[i::7][:12] if i < 7 else ''.join(
            rng.choice(list(chars), rng.integers(1, 16)))
        bg = rng.integers(0, 256, (40, 120, 3)).astype(np.uint8)
        col = [int(v) for v in rng.integers(0, 256, 3)]
        org = (int(rng.integers(-10, 110)), int(rng.integers(-3, 45)))
        want = bg.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.45, col, 1,
                    cv2.LINE_AA)
        got = torch.from_numpy(bg.copy())
        P.put_text_(got, text, org, torch.tensor(col, dtype=torch.uint8))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('case', ['sparse', 'dense', 'all_zero', 'constant',
                                  'one_value', 'uint16'])
def test_heatmap_matches_jax(case):
    rng = np.random.default_rng(7)
    s = rng.normal(0, 3, (48, 80, 3)).astype(np.float32)
    if case == 'sparse':
        s[rng.random(s.shape[:2]) < 0.9] = 0
    elif case == 'all_zero':
        s[..., 1] = 0
    elif case == 'constant':
        s[..., 1] = 2.5
    elif case == 'one_value':
        s[...] = 0
        s[3, 4, 1] = -7.0
    elif case == 'uint16':
        s = rng.integers(19900, 21000, (48, 80, 3)).astype(np.uint16)
    want = J.sensor_image_to_heatmap(s, channel=1)
    got = P.sensor_image_to_heatmap(s, channel=1, device='cpu').numpy()
    np.testing.assert_array_equal(got, want)


def test_percentiles_match_numpy():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 50, 51, 1001, 4097):
        v = (rng.normal(0, 1, n) * 10 ** rng.uniform(-3, 3)).astype(
            np.float32)
        want = np.percentile(v, [2, 98])
        got = P.percentiles(torch.from_numpy(v), (2, 98))
        assert got == [float(x) for x in want], (n, got, want)


@pytest.mark.parametrize('to_rgb', [True, False])
def test_denormalize_matches_jax(to_rgb):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2.5, (32, 48, 3)).astype(np.float32)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    want = J.denormalize_image(x, mean, std, to_rgb)
    got = P.denormalize_image(x, mean, std, to_rgb, device='cpu').numpy()
    np.testing.assert_array_equal(got, want)


def test_arrays_go_to_the_card_by_default():
    import inspect
    for fn in (P.denormalize_image, P.draw_detections,
               P.sensor_image_to_heatmap):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_committed_tables_equal_cv2():
    """The glyph table and TURBO are what `cv2` renders now
    (`tests/oracles/make_render_tables.py --check`)."""
    from tests.oracles import make_render_tables
    assert make_render_tables.check() == []
