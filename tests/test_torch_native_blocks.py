"""fairseq's token-block utilities in the port
(`omni_avsr_tpu_torch/utils/native.py::token_block_slices_native`,
`block_to_dataset_index_native`, bound to `native/editdist.cpp`) against
the JAX package's (`omni_avsr_tpu/utils/native.py`) in every break mode, on
random sentence sizes from a seed: bit-equal. Each is held against its
plain Python reference (`*_py`) too, and an invalid mode raises.
"""

import numpy as np
import pytest

MODES = ["none", None, "complete", "complete_doc", "eos"]


def _sizes(seed: int, n: int = 60):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 12, size=n).astype(np.int64)
    sizes[rng.rand(n) < 0.15] = 1  # document separators for "complete_doc"
    return sizes


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [1, 7, 32])
def test_token_blocks_match_jax(mode, block):
    from omni_avsr_tpu.utils import native as J
    from omni_avsr_tpu_torch.utils import native as P

    for seed in range(3):
        sizes = _sizes(seed)
        got = P.token_block_slices_native(sizes, mode, block)
        want = J.token_block_slices_native(sizes, mode, block)
        assert got.dtype == np.int64 and got.shape[1:] == (2,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, P.token_block_slices_py(sizes, mode, block))
        if len(got):
            idx = P.block_to_dataset_index_native(sizes, got)
            np.testing.assert_array_equal(idx, J.block_to_dataset_index_native(sizes, got))
            np.testing.assert_array_equal(idx, P.block_to_dataset_index_py(sizes, got))
            owner = np.repeat(np.arange(len(sizes)), sizes)  # brute force: token -> sentence
            starts = np.concatenate([[0], np.cumsum(sizes)])
            for (s, e), (a, off, b) in zip(got, idx):
                assert (a, off, b) == (owner[s], s - starts[owner[s]], owner[max(s, e - 1)])


@pytest.mark.parametrize("sep", [1, 3])
def test_document_separator_length(sep):
    from omni_avsr_tpu.utils import native as J
    from omni_avsr_tpu_torch.utils import native as P

    sizes = _sizes(7)
    sizes[::5] = sep
    got = P.token_block_slices_native(sizes, "complete_doc", 20, document_sep_len=sep)
    np.testing.assert_array_equal(got, J.token_block_slices_native(sizes, "complete_doc", 20,
                                                                   document_sep_len=sep))
    np.testing.assert_array_equal(got, P.token_block_slices_py(sizes, "complete_doc", 20, sep))


def test_invalid_mode_raises():
    from omni_avsr_tpu_torch.utils import native as P

    for fn in (P.token_block_slices_native, P.token_block_slices_py):
        with pytest.raises(ValueError, match="Invalid break_mode: bogus"):
            fn([1, 2], "bogus", 4)


@pytest.mark.parametrize("slices", [[[0, 3], [12, 12]], [[-1, 2]], [[4, 2]], [[5, 9], [0, 3]],
                                    [[0, 13]]])
def test_block_index_refuses_slices_outside_the_tokens(slices):
    """The library reads sentence sizes through a cursor the slices move
    forward: a slice past the last token or ending before it starts would
    read past the sizes, starts out of order would give wrong coordinates,
    so each is refused first."""
    from omni_avsr_tpu_torch.utils import native as P

    with pytest.raises(ValueError, match="within the sentences' tokens"):
        P.block_to_dataset_index_native([4, 2, 6], np.asarray(slices))
