"""Utility contract tests (reference _utils.py parity)."""

import numpy as np
import pytest

from nbmf_mm_jax.utils import check_is_fitted, generate_synthetic_binary_data


def test_generate_synthetic_shapes_and_binary():
    X, W, H = generate_synthetic_binary_data(
        n_samples=30, n_features=20, n_components=4, random_state=0
    )
    assert X.shape == (30, 20)
    assert W.shape == (30, 4)
    assert H.shape == (4, 20)
    assert set(np.unique(X)) <= {0.0, 1.0}


def test_generate_synthetic_reproducible():
    X1, _, _ = generate_synthetic_binary_data(random_state=3)
    X2, _, _ = generate_synthetic_binary_data(random_state=3)
    np.testing.assert_array_equal(X1, X2)


def test_generate_synthetic_mean_link():
    X, W, H = generate_synthetic_binary_data(random_state=0, link="mean")
    np.testing.assert_allclose(W.sum(axis=1), 1.0)
    P = W @ H
    assert np.all((P >= 0) & (P <= 1))


def test_check_is_fitted_message():
    class Foo:
        pass

    with pytest.raises(ValueError, match="This Foo instance is not fitted yet."):
        check_is_fitted(Foo(), "components_")
    f = Foo()
    f.components_ = 1
    check_is_fitted(f, ["components_"])  # no raise


def test_compilation_cache_helpers(tmp_path, monkeypatch):
    """enable_compilation_cache leaves a JAX_COMPILATION_CACHE_DIR choice to
    JAX and otherwise points JAX at the fixed <checkout>/.jax_cache."""
    import os

    import jax

    from nbmf_mm_jax.utils import cache

    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    prev = {k: getattr(jax.config, k) for k in names}
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        assert cache.enable_compilation_cache() == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir is None  # nothing set in code

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        target = tmp_path / "checkout" / ".jax_cache"
        monkeypatch.setattr(cache, "_DEFAULT_DIR", str(target))
        assert cache.enable_compilation_cache() == str(target) and target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        monkeypatch.undo()
        assert cache._DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
