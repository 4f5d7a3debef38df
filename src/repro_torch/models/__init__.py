"""The LM stack: every family of the reference, for training, prefill and
decode.

    common       rmsnorm, RoPE, the initializers and the next-token loss
    attention    GQA attention: chunked online-softmax prefill, cached decode
    ffn          SwiGLU / GELU FFN
    moe          top-k token-choice MoE (single-device path)
    mamba2       Mamba2 (SSD): chunked prefill, recurrent decode
    rwkv6        time-mix (chunked wkv: the CUDA kernel B7 on the card) and
                 channel-mix, full-sequence and single-token forms
    transformer  the layer loop over layer-stacked parameters (dense, audio,
                 vlm, moe, ssm and hybrid families)
    model        init_params / init_serving_params, forward, the train
                 step (init_opt_state, loss_and_grads, make_train_step),
                 the prefill and decode steps
"""
