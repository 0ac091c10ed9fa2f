"""PyTorch model zoo: the IBN ConvNets the NAS search trains
(``convnets``) and the dense transformer families (``transformer``,
``layers``, dispatched by ``api``). The moe, ssm and hybrid families are
not ported yet."""
