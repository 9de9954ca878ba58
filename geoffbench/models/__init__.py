"""Model modules: one file a model family, found by the name in a
configuration file's ``"model"`` key (``dense`` where it names none) by
``spec.model``. A module is plain PyTorch: it imports nothing of the
program, only torch and the benchmark's yardstick (``counts``,
``reference``, ``weights``). It defines, each from ``arch``, the
configuration's ``port`` group:

  layout(arch)          {path: (shape, std)} or {path: (shape, std, dtype)}
                        of every weight, in drawing order (``weights.make``
                        draws them; the dtype defaults to bf16 for two or
                        more dims, float32 otherwise)
  last_logits(arch, weights, inputs, precision, eps)
                        the float32 reference's logits at each input's last
                        position, or with ``precision="fp8"`` the control's
  prefill_flops(arch, text_len, patches)
                        the model operations of one prefill
  bounds(arch, text_len, patches)
                        {pattern group: seconds}: the least device time of
                        one prefill's work in each kernel group, whose
                        kernels ``metrics/patterns/<group>/*.txt`` name
"""
