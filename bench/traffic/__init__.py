"""The token stream the traffic mixes draw from."""
