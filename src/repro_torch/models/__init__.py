"""The LM stack: the ``ssm`` family (RWKV6) for prefill and decode.

    common       rmsnorm and the initializers
    rwkv6        time-mix (chunked wkv: the CUDA kernel B7 on the card) and
                 channel-mix, full-sequence and single-token forms
    transformer  the layer loop over layer-stacked parameters
    model        init_params, forward, the prefill and decode steps
"""
