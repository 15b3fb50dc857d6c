"""Drivers: ``launch.serve`` runs Clover's real-mode control loop on the
port's serving engine; ``launch.train`` trains a reduced architecture with
checkpoint/restart."""
