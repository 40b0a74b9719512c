"""bench.py is a driver contract (one JSON line): a broken import or LUT
builder would cost a run its evidence, so smoke the host-side pieces on
CPU. The device measurement itself runs on the accelerator, not here."""

import numpy as np


def test_bench_lut_builders():
    import bench

    lut, cube = bench._make_lut()
    assert lut.size == 33
    assert cube.exists() and cube.suffix == ".cube"
    assert np.all(lut.table >= 0) and np.all(lut.table <= 1)
    l65 = bench._film_lut65()
    assert l65.size == 65
    assert np.all(l65.table >= 0) and np.all(l65.table <= 1)
    # the big-cube cells resample the same grade onto 97^3 / 129^3
    l97 = bench._resampled(l65, 97)
    assert l97.table.shape == (97, 97, 97, 3)
    np.testing.assert_allclose(l97.table[0, 0, 0], l65.table[0, 0, 0])
    np.testing.assert_allclose(l97.table[-1, -1, -1], l65.table[-1, -1, -1])


def test_bench_kernel_parity_helper():
    """The parity probe bench reports must stay runnable host-side."""
    import bench

    lut, cube = bench._make_lut()
    d = bench.measure_kernel_parity(lut, cube)
    assert d < 0.01, d
