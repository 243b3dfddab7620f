"""Device selection and synthetic test models."""
