"""Device selection and weight carry-over."""
