"""Camera trajectories for the validation videos (numpy and scipy)."""
