"""Bank compiler, ρ ladder and the solve loop."""
