"""The paper's host-side math (quantizers, cost model, codesign solvers)."""
