"""The warm start of a delta routing table, from its definition.

The program states that ``update_path_system`` keeps ("splices") a
commodity's routes, row for row, when its source and destination switch
pair routed before, none of its old paths crosses a removed link, its hop
distance is unchanged, and no path through an added link is short enough
to enter its k-shortest set (no longer than its longest kept path when it
had ``k`` paths, else than its distance plus the slack); every other
commodity is enumerated afresh.  A warm MW solve starts each kept row from
the predecessor's rate on that row; a commodity's fresh rows start from a
twentieth of its kept rows' mean, or from 1 where it kept none.

``warm_split`` computes that starting split on the reference's own tables,
from the reference's own predecessor solution.  Plain NumPy.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.frozen.topology import edge_delta

__all__ = ["warm_split"]


def warm_split(old_top, old_comm, old_routes, old_rates, new_top, new_comm,
               new_routes, k: int, max_slack: int, dist_old, dist_new):
    """Per-path starting split of ``new_routes`` (float64), or the fraction
    of its commodities kept, as ``(x0, kept_share)``."""
    n_new = new_top.n_switches
    added, removed, _ = edge_delta(old_top, new_top)
    E_old = old_top.n_edges
    # old routed commodities: their rows, longest path, whether any row
    # crosses a removed link
    old_routed = np.flatnonzero(~old_routes.unrouted)
    pe = old_routes.path_edges
    valid = pe < 2 * E_old
    broken_row = (removed[np.where(valid, pe % max(E_old, 1), 0)] & valid).any(1)
    n_old = len(old_routes.demands)
    cnt = np.bincount(old_routes.path_owner, minlength=n_old)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    maxlen = np.zeros(n_old)
    np.maximum.at(maxlen, old_routes.path_owner, old_routes.path_len)
    broken = np.zeros(n_old, dtype=bool)
    np.logical_or.at(broken, old_routes.path_owner, broken_row)
    # the first old commodity of each (src, dst) pair
    old_key = {}
    for j in range(len(old_comm.src) - 1, -1, -1):
        old_key[int(old_comm.src[j]) * n_new + int(old_comm.dst[j])] = j
    routed_index = np.full(len(old_comm.src), -1, dtype=np.int64)
    routed_index[old_routed] = np.arange(len(old_routed))

    src, dst = np.asarray(new_comm.src), np.asarray(new_comm.dst)
    if len(added):
        au, av = added[:, 0], added[:, 1]
        via = np.minimum(dist_new[np.ix_(src, au)] + dist_new[np.ix_(dst, av)],
                         dist_new[np.ix_(src, av)] + dist_new[np.ix_(dst, au)]
                         ).min(axis=1) + 1.0
    else:
        via = np.full(len(src), np.inf)
    new_routed = np.flatnonzero(~new_routes.unrouted)
    n_cnt = np.bincount(new_routes.path_owner, minlength=len(new_routed))
    n_first = np.concatenate([[0], np.cumsum(n_cnt)[:-1]])
    x0 = np.zeros(new_routes.n_paths)
    kept = 0
    for c, j in enumerate(new_routed):
        oj = old_key.get(int(src[j]) * n_new + int(dst[j]))
        if oj is None or routed_index[oj] < 0:
            continue
        oc = routed_index[oj]
        d_new = dist_new[src[j], dst[j]]
        budget = maxlen[oc] if cnt[oc] >= k else d_new + max_slack
        if (broken[oc] or dist_old[old_comm.src[oj], old_comm.dst[oj]] != d_new
                or not via[j] > budget or n_cnt[c] != cnt[oc]):
            continue
        x0[n_first[c]: n_first[c] + n_cnt[c]] = old_rates[
            first[oc]: first[oc] + cnt[oc]]
        kept += 1
    mean = np.bincount(new_routes.path_owner, weights=x0,
                       minlength=len(new_routed)) / np.maximum(n_cnt, 1)
    m = mean[new_routes.path_owner]
    x0 = np.maximum(x0, np.where(m > 0, 0.05 * m, 1.0))
    return x0, kept / max(len(new_routed), 1)
