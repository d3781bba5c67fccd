"""Result records, query translation and consistency validation."""
