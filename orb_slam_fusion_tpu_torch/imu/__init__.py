"""IMU preintegration and inertial residuals."""
