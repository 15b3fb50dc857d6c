"""Drivers: ``launch.serve`` runs Clover's real-mode control loop on the
port's serving engine."""
