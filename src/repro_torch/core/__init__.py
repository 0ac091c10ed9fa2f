"""The NAHAS core of the port: the paper's joint NAS+HAS search stack.

space/nas/has define the symbolic search spaces, controllers the samplers
(PPO / REINFORCE on torch, evolution in numpy), engine the batched+cached
EvaluationEngine, simulator the analytic hardware model, proxy the accuracy
signals (TrainedAccuracy trains on the card), costmodel the learned
latency/area/energy MLP (Sec. 3.5.2), oneshot the weight-sharing supernet
search, reward the Eq. 4-6 objective, scenarios/pareto the use-case
registry (with the LLM scenario grid) and frontier, search/session the
drivers, and meshsearch the pod mesh search over the roofline backend.
Mirrors ``repro.core`` apart from the sweep.
"""
