"""The NAHAS core of the port: the paper's joint NAS+HAS search stack.

space/nas/has define the symbolic search spaces, controllers the samplers
(PPO / REINFORCE on torch, evolution in numpy), engine the batched+cached
EvaluationEngine, simulator the analytic hardware model, proxy the accuracy
signals (TrainedAccuracy trains on the card), reward the Eq. 4-6 objective,
scenarios/pareto the use-case registry and frontier, and search/session the
drivers. Mirrors ``repro.core``; the learned cost model, oneshot, the mesh
search and the sweep are not ported yet.
"""
