"""On the card: the program's kernels (``use_pallas``) against the plain
reference at full width, two layers deep, and the fp8 control beside
them. Skips without a CUDA card."""
import pytest
import torch

from geoffbench import check, spec, traffic, weights


@pytest.mark.card
@pytest.mark.parametrize("config,lengths", [("qwen3-32b", (4096, 1536, 300)),
                                            ("llava-next-34b", (512, 96, 32))])
def test_control_reads_far_above_the_program_at_full_width(card, config, lengths):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    bench = spec.load_benchmark()
    conf = spec.config(bench, config)
    model = spec.model(conf)
    arch = dict(conf["port"], num_layers=2)
    params = weights.make(model.layout(arch), 2**31 + 77, card)
    cfg = ArchConfig(**dict(arch, block_pattern=tuple(arch["block_pattern"])))
    inputs, got = [], []
    for i, n in enumerate(lengths):
        r = traffic.Request(i, n, arch["num_patches"], 0.0)
        inp = {"tokens": traffic.text_tokens(77, r, arch["vocab_size"]).to(card)}
        if r.patches:
            inp["patches"] = traffic.page_patches(77, r, arch["d_model"], card)
        batch = {k: v[None] for k, v in inp.items()}
        with torch.no_grad():
            got.append(M.prefill(cfg, params, batch)[0][0].float())
        inputs.append(inp)
    ref = model.last_logits(arch, params, inputs, "float32", 1e-6)
    low = model.last_logits(arch, params, inputs, "fp8", 1e-6)
    prog = check.compared([int(g.argmax()) for g in got], got, ref)
    ctrl = check.compared([int(x.argmax()) for x in low], low, ref)
    assert prog["label_not_argmax"] == 0
    assert ctrl["logits_rel_err"] > 3 * prog["logits_rel_err"]
