"""The frozen bound arithmetic against the kernel table's bound column
(PERF.md, "Kernel table": max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s))."""

import pytest

from portbench.counts import kernels as K

# (entry point, its integer launch arguments, the table's bound in ms)
ROWS = [
    ("#1 self L0", K.attention(2, 8, 6144, 6144, 40), 0.0977),
    ("#1 self L1", K.attention(2, 8, 1536, 1536, 80), 0.0122),
    ("#1 cross L0", K.attention(2, 8, 6144, 231, 40), 0.0049),
    ("#1 cross L1", K.attention(2, 8, 1536, 231, 80), 0.0027),
    ("#2 VAE mid", K.attention(1, 1, 6144, 6144, 512), 0.0782),
    ("#2 2-frame VAE", K.attention(2, 1, 6144, 6144, 512), 0.1563),
    ("#2 L2 d160", K.attention(2, 8, 1536, 1536, 160), 0.0244),
    ("#3 QKV L0", K.linear_ln(12288, 320, 960), 0.0096),
    ("#3 Q L0", K.linear_ln(12288, 320, 320), 0.0048),
    ("#3 QKV L1", K.linear_ln(6144, 640, 1920), 0.0153),
    ("#3 Q L1", K.linear_ln(6144, 640, 640), 0.0051),
    ("#4 L0", K.geglu(12288, 320, 1280), 0.0305),
    ("#4 L1", K.geglu(6144, 640, 2560), 0.0611),
    ("#6 inject L0", K.attention_keymask(2, 8, 6144, 12288, 40, 6144, 1),
     0.1466),
    ("#6 inject L1", K.attention_keymask(2, 8, 1536, 3072, 80, 1536, 1),
     0.0183),
    ("#6 inject L2 d160", K.attention_keymask(2, 8, 1536, 3072, 160, 1536, 1),
     0.0366),
    ("#10 strip L0", K.attention(2, 8, 12288, 12288, 40), 0.3908),
    ("#10 strip L1", K.attention(2, 8, 3072, 3072, 80), 0.0489),
]


@pytest.mark.parametrize("name,counts,bound_ms", ROWS,
                         ids=[r[0] for r in ROWS])
def test_bound_matches_table(name, counts, bound_ms):
    assert K.bound_s(*counts) * 1e3 == pytest.approx(bound_ms, abs=6e-5)


def test_family_share_pairs_calls_with_kernels():
    # two attention calls; a trace with their two kernels, 1 ms each
    args = (0, 0, 0, 0, 2, 8, 6144, 6144, 40)
    calls = [("sdaof_attention", args)] * 2
    ker = [("void attention_sm90_kernel<48, 0, 3>(Params)", 0, 1_000_000, 1),
           ("void attention_sm90_kernel<48, 0, 3>(Params)", 0, 1_000_000, 2)]
    share = K.family_share(calls, ker, "attn")
    assert share == pytest.approx(K.bound_s(*K.attention(2, 8, 6144, 6144,
                                                         40)) / 1e-3)
    assert K.family_share(calls[:1], ker, "attn") is None
    geglu = ("sdaof_geglu", (0,) * 9 + (12288, 320, 1280))
    ffn = [("void geglu_up_sm90_kernel<64>()", 0, 500, 3),
           ("void geglu_down_sm90_kernel<160>()", 0, 500, 4)]
    assert K.family_share([geglu], ffn, "ffn") is not None
