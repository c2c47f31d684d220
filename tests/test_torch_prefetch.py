"""The port's prefetch_to_device on the CPU (device="cpu", as no card is
here) against the JAX package's prefetch_to_device: the same batches in the
same order and number, for iterators longer and shorter than the prefetch
depth and empty ones; arrays arrive as tensors with equal values, other leaves
as they were; and no quiet CPU fallback (the default device raises without
CUDA). The CUDA copy path is held bit for bit on the card
(tests/test_torch_gpu_kernels.py)."""

import numpy as np
import pytest
import torch

from tvts_torch.data.prefetch import prefetch_to_device


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"video": rng.standard_normal((2, 3, 4)).astype(np.float32),
             "keep_ind": rng.integers(0, 9, (2, 3)).astype(np.int32),
             "labels": np.tile(np.arange(4), (2, 1)),
             "mask": rng.random((2, 3)) < 0.5,
             "text": [[f"clip {c} of {i}" for i in range(2)] for c in range(4)],
             "meta": [{"paths": f"v{i}.mp4"} for i in range(2)], "step": i}
            for i in range(n)]


def _host(tree):
    """tensors back to numpy, for comparing with the JAX package's leaves."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("n,size", [(5, 2), (5, 1), (1, 2), (2, 2), (0, 2), (3, 7)])
def test_prefetch_yields_the_jax_packages_batches(n, size):
    from tvts_tpu.data.prefetch import prefetch_to_device as jax_prefetch

    got = list(prefetch_to_device(iter(_batches(n)), size=size, device="cpu"))
    want = list(jax_prefetch(iter(_batches(n)), size=size, put=lambda b: b))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in ("video", "keep_ind", "labels", "mask"):
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            assert g[key].numpy().dtype == w[key].dtype
            np.testing.assert_array_equal(g[key].numpy(), w[key])
        assert (g["text"], g["meta"], g["step"]) == (w["text"], w["meta"], w["step"])
        assert _host(g)["video"].tobytes() == w["video"].tobytes()


def test_prefetch_keeps_size_batches_in_flight():
    """The source is read `size` batches ahead of the consumer, never more."""
    pulled = []

    def source():
        for i, b in enumerate(_batches(6)):
            pulled.append(i)
            yield b

    it = prefetch_to_device(source(), size=3, device="cpu")
    assert pulled == []  # nothing is read before the first batch is asked for
    first = next(it)
    assert first["step"] == 0 and pulled == [0, 1, 2, 3]
    assert [b["step"] for b in it] == [1, 2, 3, 4, 5]


def test_prefetch_takes_a_put_and_refuses_what_it_cannot_place():
    seen = []
    out = list(prefetch_to_device(range(4), size=2, put=lambda b: seen.append(b) or b * 10))
    assert out == [0, 10, 20, 30] and seen == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="at least 1"):
        prefetch_to_device(range(3), size=0, device="cpu")
    with pytest.raises(ValueError, match="no placement"):
        prefetch_to_device(range(3), device="meta")
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prefetch_to_device(_batches(2))


def test_prefetch_passes_non_numeric_arrays_and_tensors_through():
    strings = np.array(["a", "bc"])
    t = torch.arange(3)
    (out,) = prefetch_to_device([{"s": strings, "t": t, "n": None, "tup": (np.ones(2), "x")}],
                                device="cpu")
    assert out["s"] is strings and out["n"] is None and torch.equal(out["t"], t)
    assert isinstance(out["tup"], tuple)
    assert torch.equal(out["tup"][0], torch.ones(2, dtype=torch.float64))
    assert out["tup"][1] == "x"
