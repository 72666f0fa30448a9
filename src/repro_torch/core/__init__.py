"""The iGniter planner: interference model, queueing budget, Theorem 1 and
Alg. 1/2, with the Alg. 2 grant loop on the card."""
