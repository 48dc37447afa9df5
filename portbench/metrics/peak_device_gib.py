"""The card's peak allocated memory over set-up and window, in GiB
(``torch.cuda.max_memory_allocated``, read before the check runs)."""


def read(rec):
    peak = rec.extra.get("memory_peak_bytes")
    return None if not peak else peak / 2 ** 30
