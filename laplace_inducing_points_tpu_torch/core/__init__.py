"""Core algebra: flat parameters, loss Hessians, linearization, row factors."""
