"""Evaluation scripts: render_orbit, consistency_metrics, mse_background."""
