import numpy as np
import pytest

from portbench.harness.stats import percentile, samples_beyond


@pytest.mark.parametrize("n", [1, 2, 7, 100, 131])
@pytest.mark.parametrize("q", [0, 50, 90, 100])
def test_percentile_over_all_samples(n, q):
    xs = np.random.default_rng(n).lognormal(size=n).tolist()
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_is_not_a_median_of_chunks():
    # a slow tail in one chunk: the percentile of all samples sees it
    xs = [1.0] * 90 + [10.0] * 10 + [1.0] * 20
    assert percentile(xs, 90) == pytest.approx(float(np.percentile(xs, 90)))
    assert percentile(xs, 95) == 10.0


def test_samples_beyond_p90():
    assert samples_beyond(100, 90) == 10
    assert samples_beyond(120, 90) == 12
    assert samples_beyond(99, 90) == 10
