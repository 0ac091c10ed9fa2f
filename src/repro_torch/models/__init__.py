"""PyTorch model zoo. So far the IBN ConvNets the NAS search trains
(``convnets``); the LLM families are not ported yet."""
