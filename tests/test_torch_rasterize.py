"""The port's polygon rasterizers against the JAX package's.

The port's default (``backend="auto"``/``"pil"``) is its C++ copy of
Pillow's polygon fill and must equal ``ugpg_tpu``'s PIL default bit for
bit: no tolerance.  ``"native"`` and ``"numpy"`` must equal the JAX
package's same backends.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_data_monuseg import make_xml
from ugpg_tpu.data import rasterize as jax_rasterize
from ugpg_tpu_torch.data import rasterize

SQUARE = [(8, 8), (24, 8), (24, 24), (8, 24)]
CASES = {
    "square": ([SQUARE], (32, 32)),
    "concave": ([[(2, 2), (28, 2), (28, 28), (15, 10), (2, 28)]], (32, 32)),
    "partly_off_tile": ([[(-5, -3), (12, -7), (20, 9), (3, 14)],
                         [(25, 20), (40, 22), (38, 40), (22, 35)]], (32, 32)),
    "half_vertices": ([[(2.5, 3.5), (20.5, 5.5), (15.5, 25.5)],
                       [(-1.5, 10.5), (6.5, 12.5), (0.5, 20.5)]], (32, 32)),
    "self_intersecting": ([[(2, 2), (28, 28), (28, 2), (2, 28)]], (32, 32)),
    "thin_and_horizontal": ([[(3, 5), (9, 5), (17, 5), (17, 6), (3, 6)],
                             [(20, 10), (21, 30), (22, 10)]], (32, 32)),
}


def _polys(spec):
    return [np.asarray(p, np.float64) for p in spec]


def _nuclei(rng, n, size, lo=8, hi=21):
    out = []
    for _ in range(n):
        k = rng.integers(lo, hi)
        c = rng.uniform(0, size, 2)
        r = rng.uniform(4, 12)
        a = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = r * rng.uniform(0.7, 1.0, k)
        out.append(np.stack([c[0] + rad * np.cos(a), c[1] + rad * np.sin(a)], 1))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_fill_equals_pil_bit_for_bit(case):
    spec, hw = CASES[case]
    polys = _polys(spec)
    want = jax_rasterize.rasterize_polygons(polys, hw, backend="pil")
    for backend in ("auto", "pil"):
        got = rasterize.rasterize_polygons(polys, hw, backend=backend)
        assert got.dtype == np.uint8 and got.shape == hw
        np.testing.assert_array_equal(got, want, err_msg=f"{case} {backend}")


def test_square_fills_pillows_289_pixels():
    assert rasterize.rasterize_polygons(_polys([SQUARE]), (32, 32)).sum() == 289  # 17 x 17
    # the even-odd scanline stops one row short
    assert rasterize.rasterize_polygons(_polys([SQUARE]), (32, 32), backend="native").sum() == 272


def test_tile_of_nuclei_equals_pil():
    polys = _nuclei(np.random.default_rng(0), 400, 1000)
    got = rasterize.rasterize_polygons(polys, (1000, 1000))
    want = jax_rasterize.rasterize_polygons(polys, (1000, 1000), backend="pil")
    np.testing.assert_array_equal(got, want)


_coord = st.floats(min_value=-12.0, max_value=52.0, allow_nan=False, allow_infinity=False)
_polygon = st.lists(st.tuples(_coord, _coord), min_size=3, max_size=12)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(polys=st.lists(_polygon, min_size=1, max_size=4),
       h=st.integers(4, 40), w=st.integers(4, 40), snap=st.sampled_from([0, 1, 2]))
def test_random_polygons_equal_pil(polys, h, w, snap):
    # snap 1: integer vertices, 2: half-integers (ties), 0: any float
    arrays = [np.asarray(p, np.float64) for p in polys]
    if snap:
        arrays = [np.round(a * snap) / snap for a in arrays]
    want = jax_rasterize.rasterize_polygons(arrays, (h, w), backend="pil")
    np.testing.assert_array_equal(rasterize.rasterize_polygons(arrays, (h, w)), want)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_other_backends_equal_jax(backend):
    rng = np.random.default_rng(1)
    polys = _nuclei(rng, 30, 200, lo=3, hi=11) + _polys(CASES["partly_off_tile"][0])
    got = rasterize.rasterize_polygons(polys, (200, 200), backend=backend)
    want = jax_rasterize.rasterize_polygons(polys, (200, 200), backend=backend)
    np.testing.assert_array_equal(got, want)


def test_empty_and_bad_backend():
    for backend in ("auto", "native", "numpy"):
        mask = rasterize.rasterize_polygons([], (5, 7), backend=backend)
        assert mask.shape == (5, 7) and mask.sum() == 0
    with pytest.raises(ValueError, match="backend"):
        rasterize.rasterize_polygons([], (5, 7), backend="pillow")


def test_parse_info_and_xml_to_mask_equal_jax(tmp_path):
    p = tmp_path / "a.xml"
    polys = CASES["half_vertices"][0] + [[(0, 0), (1, 1)]]  # the last has 2 vertices
    p.write_text(make_xml(polys))
    got, want = rasterize.parse_polygons(p), jax_rasterize.parse_polygons(p)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rasterize.annotation_info(p) == jax_rasterize.annotation_info(p)
    np.testing.assert_array_equal(rasterize.xml_to_mask(p, (40, 30)),
                                  jax_rasterize.xml_to_mask(p, (40, 30)))
