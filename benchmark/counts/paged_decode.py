"""Bytes of one paged decode attention call (one layer, one token a slot):
each decoding slot's K and V rows up to its length in the cache's type,
its query read and its output written in the activations' type."""


def call_bytes(context_sum: int, slots: int, d: int, kv_bytes: int = 4,
               elem_bytes: int = 2) -> float:
    return float(2 * context_sum * d * kv_bytes + 2 * slots * d * elem_bytes)
