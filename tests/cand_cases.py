"""Candidate blocks for the K4 / K5 and candidate-list tests, made with
numpy from a seed (numpy and torch only, so the card tests can use them on
a machine without JAX).

Each case returns (slabs (M, block, nbins) int8, uid_rows (block, 1) int32
or None, uid_cols (groups, nbins) int32, start, g0) and stresses one rule
of the fused tile: a group kept by two planes (the OR), slab edges whose
column has the row's uid (the username term counts those, the lists drop
them), the self pair inside and outside the block, local group ids with
g0 != 0, one user owning most of the window, empty slabs with valid uids.
"""
import numpy as np
import torch

CASES = ("random", "same_group_two_planes", "uid_on_slab_edges", "self_inside",
         "self_outside", "g0", "one_user", "empty_slabs", "no_user")


def cand_case(name: str, block: int = 64, nbins: int = 40, groups: int = 5, n_mod: int = 3,
              seed: int = 0, keep: float = 0.2):
    """The numpy operands of case ``name`` (``nbins`` 40: not a multiple of
    16, so the kernels' scalar paths run)."""
    rng = np.random.default_rng(seed)
    slabs = rng.integers(0, groups, (n_mod, block, nbins)).astype(np.int8)
    slabs[rng.random(slabs.shape) >= keep] = -1
    uid_rows = rng.integers(-1, 6, (block, 1)).astype(np.int32)
    uid_cols = rng.integers(-2, 6, (groups, nbins)).astype(np.int32)
    n = groups * nbins
    start, g0 = min(nbins // 2, n - block), 0
    if name == "same_group_two_planes":
        both = rng.random((block, nbins)) < 0.5
        slabs[1][both] = slabs[0][both]
    elif name == "uid_on_slab_edges":
        rows, slots = np.nonzero(slabs[0] >= 0)
        cols = slabs[0][rows, slots].astype(np.int64) * nbins + slots
        pick = rng.random(rows.size) < 0.5
        uid_cols.reshape(-1)[cols[pick]] = uid_rows[rows[pick], 0]
        # some of them on the row's own column
        own = start + np.arange(block)
        slabs[2][np.arange(block), own % nbins] = own // nbins
        uid_cols.reshape(-1)[own] = uid_rows[:, 0]
    elif name == "self_inside":
        uid_rows[:] = 5
        uid_cols[rng.random(uid_cols.shape) < 0.8] = 5
    elif name == "self_outside":
        start = n + 3 * nbins                  # the block's rows are no local column
        uid_rows[:] = 4
        uid_cols[rng.random(uid_cols.shape) < 0.5] = 4
    elif name == "g0":
        start, g0 = 3 * nbins + 17, 2          # own columns fall in local groups 1-3
        uid_cols[rng.random(uid_cols.shape) < 0.5] = 3
    elif name == "one_user":
        uid_rows[rng.random(block) < 0.9] = 7
        uid_cols[rng.random(uid_cols.shape) < 0.9] = 7
    elif name == "empty_slabs":
        slabs[:] = -1
    return slabs, None if name == "no_user" else uid_rows, uid_cols, start, g0


def torch_cand(cm, case, device="cpu"):
    """The port's CandBlock of a case on ``device``."""
    slabs, uid_rows, uid_cols, start, g0 = case
    return cm.CandBlock(torch.from_numpy(slabs).to(device),
                        None if uid_rows is None else torch.from_numpy(uid_rows).to(device),
                        torch.from_numpy(uid_cols).to(device), start=start, g0=g0)


def products_from_lists(lists: dict, x: np.ndarray, y: np.ndarray, *, block: int,
                        n: int, start: int, g0: int, nbins: int):
    """The kernels' formula on the plain lists, in numpy f64: K4's out_t
    (r, n) as each column's list rows plus its user's rows less its own,
    K5's out (block, r) as each row's list columns plus its user's columns
    less its own.  ``x`` (r, block), ``y`` (n, r)."""
    rowptr, rowcols = lists["rowptr"], lists["rowcols"]
    colptr, colrows = lists["colptr"], lists["colrows"]
    out_t = np.stack([x[:, colrows[colptr[c]:colptr[c + 1]]].sum(1) for c in range(n)], 1)
    out = np.stack([y[rowcols[rowptr[i]:rowptr[i + 1]]].sum(0) for i in range(block)])
    if "row_user" in lists:
        row_user, col_user = lists["row_user"], lists["col_user"]
        userptr, userrows = lists["userptr"], lists["userrows"]
        ucolptr, ucols = lists["ucolptr"], lists["ucols"]
        nu = int(lists["nu"][0])
        usum = np.stack([x[:, userrows[userptr[u]:userptr[u + 1]]].sum(1) for u in range(nu)])
        vsum = np.stack([y[ucols[ucolptr[u]:ucolptr[u + 1]]].sum(0) for u in range(nu)])
        for c in range(n):
            u = col_user[c]
            if u >= 0:
                out_t[:, c] += usum[u]
                i = g0 * nbins + c - start
                if 0 <= i < block and row_user[i] == u:
                    out_t[:, c] -= x[:, i]
        for i in range(block):
            u = row_user[i]
            out[i] += vsum[u]
            c = start + i - g0 * nbins
            if 0 <= c < n and col_user[c] == u:
                out[i] -= y[c]
    return out_t, out
