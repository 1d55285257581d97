"""Wrapper: paged decode attention with the reference's argument types."""
from __future__ import annotations

from repro_torch.kernels.decode_attention.decode_attention import \
    paged_decode_attention_kernel


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens):
    """q [B, H, d] (one token per sequence); pages [n_slots, page, d*];
    page_table [B, P]; seq_lens [B].  Returns [B, H, dv]."""
    return paged_decode_attention_kernel(q, k_pages, v_pages,
                                         page_table.int(), seq_lens.int())
