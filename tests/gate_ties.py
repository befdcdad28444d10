"""Gate-select inputs whose scores are exact in any summation order.

qg and the Kg rows hold integers in [-3, 3], exact in bf16 and fp32, and
every dot product of at most 1024 of them is an integer below 2**24, so
any kernel, the plain version and the JAX reference get the same fp32
score. Each (b, kv-head) draws its rows from a few distinct ones, so many
blocks tie exactly and the lower-index rule decides their order. numpy
only: the CPU tests (against the JAX package) and the card tests share it.
"""
import numpy as np

N_DISTINCT = 7          # distinct Kg rows a (b, kv-head) draws from


def n_valid(b: int, nb: int) -> np.ndarray:
    """Visible blocks per row: full, partial, 1, repeated."""
    return np.array(([nb, nb // 2 + 1, 1] * b)[:b], np.int32)


def contiguous(seed: int, b: int, hkv: int, nb: int, dg: int):
    """-> (qg [b, hkv, dg], kg [b, hkv, nb, dg]) float32."""
    r = np.random.default_rng(seed)
    qg = r.integers(-3, 4, (b, hkv, dg)).astype(np.float32)
    rows = r.integers(-3, 4, (b, hkv, N_DISTINCT, dg)).astype(np.float32)
    return qg, np.ascontiguousarray(rows[:, :, r.integers(0, N_DISTINCT, nb)])


def paged(seed: int, s: int, hkv: int, npt: int, dg: int, nv: np.ndarray,
          shuffle: bool = True):
    """-> (qg [s, hkv, dg], kg_pages [s * npt + 1, hkv, dg] float32,
    page_table [s, npt] int32). Row i's first nv[i] logical blocks map to
    distinct pages (in order, or shuffled over the pool), the rest to the
    null page 0. The pool's rows are drawn from a few distinct ones. With
    one seed the shuffled and unshuffled pools hold the same logical rows."""
    r = np.random.default_rng(seed)
    qg = r.integers(-3, 4, (s, hkv, dg)).astype(np.float32)
    rows = r.integers(-3, 4, (N_DISTINCT, hkv, dg)).astype(np.float32)
    logical = rows[r.integers(0, N_DISTINCT, (s, npt))]          # [s, npt, hkv, dg]
    n_pages = s * npt + 1
    pages = 1 + np.arange(s * npt).reshape(s, npt)
    if shuffle:
        pages = 1 + r.permutation(s * npt).reshape(s, npt)
    pool = np.zeros((n_pages, hkv, dg), np.float32)
    pool[0] = rows[0]                                            # the null page
    pool[pages] = logical
    table = np.where(np.arange(npt)[None] < nv[:, None], pages, 0).astype(np.int32)
    return qg, pool, table
