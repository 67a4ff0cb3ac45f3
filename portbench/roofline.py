"""The yardstick of the traversal roofline: the least bytes a table walk
must move, and the card's memory rate. The arithmetic is that of the
port's roofline tool (a live ray's o, d and t_max read once, a dead ray's
t_max alone, each output written once, the tables once), frozen here.

The bound is of bytes only: the operations side needs each call's
entered-tile counts, which only the program can count.
"""

from __future__ import annotations

# Published memory rates (NVIDIA's data sheets) by torch.cuda.get_device_name().
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM, at its 700 W limit
}
RAY_IN_BYTES = 28  # o, d (12 B each) and t_max (4 B)
T_MAX_BYTES = 4  # all a dead ray (t_max 0) needs read: its result is fixed


def call_bytes(n_rays: int, live: int, out_bytes: int, table_bytes: int) -> int:
    """Bytes one table walk over n_rays rays, `live` of them with t_max > 0,
    must move at least."""
    return live * RAY_IN_BYTES + (n_rays - live) * T_MAX_BYTES + out_bytes + table_bytes


def bound_s(calls, card: str):
    """Σ over calls ({"rays", "live", "out_bytes", "table_bytes"}) of the
    least bytes over the card's memory rate, in seconds; None for a card
    the table does not know."""
    rate = HBM_BYTES_PER_S.get(card)
    if rate is None:
        return None
    return sum(call_bytes(c["rays"], c["live"], c["out_bytes"], c["table_bytes"])
               for c in calls) / rate
