"""KAPPA controller: signals, scoring, robustification, schedules."""
