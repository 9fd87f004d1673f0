"""FLOP and byte counts against shapes worked by hand."""
import json

import pytest

from ooco_bench import counts
from ooco_bench.cell import HERE
from ooco_bench.weights import dims

QWEN = dims(json.loads((HERE / "configs" / "qwen2.5-7b.json").read_text()))
PHI3 = dims(json.loads((HERE / "configs" / "phi-3-vision-4.2b.json").read_text()))


def test_dims():
    assert QWEN == {"L": 28, "d": 3584, "Hq": 28, "Hkv": 4, "hd": 128, "ff": 18944, "V": 152064}
    assert PHI3 == {"L": 32, "d": 3072, "Hq": 32, "Hkv": 32, "hd": 96, "ff": 8192, "V": 32064}


def test_kv_bytes_a_token():
    # one key and value a layer: qwen 4 x 128 x 2 x 2 x 28 = 57,344 B; phi-3 393,216 B
    for n, per_token in ((QWEN, 57344), (PHI3, 393216)):
        b, _ = counts.paged_decode(n, keys=1000, rows=0)
        assert b * n["L"] == 1000 * per_token


def test_paged_decode_qwen_by_hand():
    # 8 rows of 512 keys: K,V 4096 keys x 4 heads x 128 x 2 B x 2; q,out 8 x 28 x 128 x 2 B x 2
    b, f = counts.paged_decode(QWEN, keys=8 * 512, rows=8)
    assert b == 4096 * 4 * 128 * 2 * 2 + 8 * 28 * 128 * 2 * 2
    assert f == 4 * 128 * 28 * 4096
    assert counts.least_seconds(b, f) == pytest.approx(b / 3.35e12)


def test_flash_chunk_phi3_by_hand():
    # 256 queries at offset 320 over 576 keys: pairs 256 x 320 + 256 x 257 / 2
    b, f = counts.flash_chunk(PHI3, q_offset=320, s=256)
    pairs = 256 * 320 + 256 * 257 / 2
    assert f == 4 * 96 * 32 * pairs
    assert b == 2 * (2 * 256 * 32 * 96 + 2 * 576 * 32 * 96)


def test_model_flops_qwen():
    per_layer = 3584 * 3584 + 2 * 3584 * 512 + 3584 * 3584 + 3 * 3584 * 18944
    assert counts.layer_matmul_params(QWEN) == per_layer == 233_046_016
    # 2 FLOPs a multiplied weight, the output projection's included and the
    # embedding's lookup not: 14.14 GFLOP a token (2 x 7.6 G parameters is 15.2)
    f = counts.decode_token_flops(QWEN, keys=0)
    assert f == 28 * 2 * per_layer + 2 * 3584 * 152064
    assert 14.1e9 < f < 14.2e9
    # a whole prompt as one chunk: causal pairs n(n+1)/2 and one output projection
    n = 1024
    assert counts.chunk_flops(QWEN, 0, n, True) == pytest.approx(
        28 * (2 * per_layer * n + 4 * 28 * 128 * n * (n + 1) / 2) + 2 * 3584 * 152064)
    # a chunk split in two costs what the whole one does
    assert counts.chunk_flops(QWEN, 0, 600, False) + counts.chunk_flops(QWEN, 600, 424, True) \
        == pytest.approx(counts.chunk_flops(QWEN, 0, 1024, True))
