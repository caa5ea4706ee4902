"""Shortest-augmenting-path Hungarian solver in plain PyTorch (port of
human_pose_tpu/ops/hungarian.py).

This is the solver of the grouping's plain path (CPU tensors); on the card
the whole grouping runs in ``csrc/match_by_tag.cu``, which repeats this
arithmetic step for step. Jonker-Volgenant style with row/column potentials
on a square float32 cost matrix, 1-indexed with a virtual column 0:

* argmin ties go to the lowest column index;
* only the first ``num_valid_rows`` rows are assigned, in row order (no
  column-reduction initialisation: it finds a co-optimal assignment that can
  differ on ties from the reference's);
* rectangular problems are padded by the caller with an equal constant just
  above the largest real cost (a 1e10 pad breaks float32 potentials).
"""

from __future__ import annotations

import torch

INF = 1e18


def hungarian(cost: torch.Tensor, num_valid_rows: int | None = None) -> torch.Tensor:
    """Min-cost matching on a square ``[n, n]`` float32 cost matrix.

    Returns ``[n]`` int64: the column assigned to each row, -1 for rows past
    ``num_valid_rows`` and unassigned rows.
    """
    n = cost.shape[0]
    cost = cost.to(torch.float32)
    dev = cost.device
    u = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    p = [0] * (n + 1)  # p[j] = row (1-based) matched to column j
    inf_col = torch.full((1,), INF, dtype=torch.float32, device=dev)
    rows = n if num_valid_rows is None else min(int(num_valid_rows), n)
    for i in range(1, rows + 1):
        p[0] = i
        minv = torch.full((n + 1,), INF, dtype=torch.float32, device=dev)
        used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        way = [0] * (n + 1)
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = torch.cat([inf_col, cost[i0 - 1] - u[i0] - v[1:]])
            upd = (~used) & (cur < minv)
            for j in torch.nonzero(upd).flatten().tolist():
                way[j] = j0
            minv = torch.where(upd, cur, minv)
            masked = torch.where(used, inf_col, minv)
            masked[0] = INF
            j1 = int(torch.argmin(masked))  # first minimum: lowest column
            delta = masked[j1]
            rows_used = torch.tensor(
                [p[j] for j in torch.nonzero(used).flatten().tolist()], device=dev
            )
            u[rows_used] = u[rows_used] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:  # augment along the path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = [-1] * n
    for j in range(1, n + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    return torch.tensor(col_of_row, dtype=torch.int64, device=dev)
