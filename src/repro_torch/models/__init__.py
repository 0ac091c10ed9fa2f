"""PyTorch model zoo: the IBN ConvNets the NAS search trains
(``convnets``) and the LLM families, dispatched by ``api``: the dense
transformer (``transformer``, ``layers``), Mamba2 (``ssm``), mixture of
experts (``moe``) and the Mamba2 + shared-attention hybrid (``hybrid``)."""
